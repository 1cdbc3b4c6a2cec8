"""Per-ray debug dumps for the crop window.

The reference accumulates ``debug_string`` lines of
``(loc, dir, end_loc, end_dir)`` for every ray inside the ``mark_*`` crop
rectangle and prints them after the render
(/root/reference/raytracer/LimitedRelativisticRenderEngine.py:68,123-141,
304-305).  Here: one batched probe render over the marked
pixels returning a dict of arrays (and the same human-readable string),
cheap enough to run interactively because the crop is tiny.
"""

from __future__ import annotations

import numpy as np

from ..camera.pinhole import Camera, generate_rays, pixel_grid
from ..ops import states
from ..ops.integrate import final_direction, launch
from .renderer import RenderConfig, scene_env

STATUS_NAMES = {
    states.ACTIVE: "ACTIVE", states.CAPTURED: "CAPTURED",
    states.ESCAPED: "ESCAPED", states.BUDGET: "BUDGET",
    states.DISK: "DISK", states.OBJECT: "OBJECT",
    states.INSIDE_HORIZON: "INSIDE_HORIZON", states.ERROR: "ERROR",
}


def debug_rays(scene, cam: Camera, cfg: RenderConfig) -> dict:
    """Trace the rays of the (cropped) pixel grid and return their full
    launch/termination record: ys, xs, origin, direction, end_loc, end_dir,
    lam, status, hit_obj -- all numpy, shaped (n_marked, ...).

    BH-centered coordinates for end_loc (the frame every shader works in),
    world coordinates for origin -- matching what the reference prints
    (entry loc is BH-local there too, LimitedRelativisticRenderEngine.py:265).
    """
    x0c, x1c, y0c, y1c = cfg.crop()
    ys, xs = pixel_grid(cfg.width, cfg.height, x0c, x1c, y0c, y1c)
    ys, xs = ys.ravel(), xs.ravel()
    origin, d = generate_rays(cam, cfg.width, cfg.height, ys, xs, None)
    env = scene_env(scene, cfg, cam)
    s = launch(env, origin - scene.bh.loc, d, cfg.integrator)
    end_dir = final_direction(env, s)
    return {
        "ys": np.asarray(ys), "xs": np.asarray(xs),
        "origin": np.asarray(origin), "direction": np.asarray(d),
        "end_loc": np.asarray(s.x), "end_dir": np.asarray(end_dir),
        "lam": np.asarray(s.lam), "status": np.asarray(s.status),
        "hit_obj": np.asarray(s.hit_obj),
    }


def format_debug_string(rec: dict, max_rays: int | None = None) -> str:
    """The reference's ``debug_string`` layout, one line per marked ray."""
    n = len(rec["ys"]) if max_rays is None else min(max_rays, len(rec["ys"]))
    lines = []
    for i in range(n):
        st = STATUS_NAMES.get(int(rec["status"][i]), "?")
        lines.append(
            f"[{int(rec['xs'][i])},{int(rec['ys'][i])}] "
            f"loc={np.round(rec['origin'][i], 4).tolist()} "
            f"dir={np.round(rec['direction'][i], 4).tolist()} "
            f"end_loc={np.round(rec['end_loc'][i], 4).tolist()} "
            f"end_dir={np.round(rec['end_dir'][i], 4).tolist()} "
            f"lam={float(rec['lam'][i]):.3f} {st}"
        )
    return "\n".join(lines)
