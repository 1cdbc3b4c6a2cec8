"""REAL multi-process distributed execution.

Everything else in the suite runs one process on a virtual 8-device CPU
mesh; this module spawns TWO actual processes (4 virtual devices each),
initializes ``jax.distributed`` against a local coordinator, builds the
8-device GLOBAL mesh across both, and exercises the full multi-host stack:

* ``render_image_sharded`` on the cross-process mesh, pixel-parity against
  the single-device render (the collectives really ride the
  inter-process channel);
* the multi-process branch of ``gather_image`` (process allgather);
* two ``Trainer`` steps -- the parameter-gradient psum crossing process
  boundaries -- with loss/params bit-identical on both processes.

This is the test the reference's cluster story never had ("V Run on
snellius / V Parallelization", /root/reference/README.md:238-240, with no
code in-repo) and the ground truth for the BASELINE multi-host target.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.pop("JAX_PLATFORMS", None)
import jax
jax.config.update("jax_platforms", "cpu")

port, pid = sys.argv[1], int(sys.argv[2])
# must run before anything touches the backend (importing the package
# builds module-level constants)
jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=2,
                           process_id=pid)
from blackhole_geodesic_calculator_tpu.parallel import init_distributed
# second call exercises the documented already-initialized no-op branch
assert init_distributed(f"127.0.0.1:{port}", num_processes=2,
                        process_id=pid) is True
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
assert len(jax.local_devices()) == 4

import dataclasses
import numpy as np
import jax.numpy as jnp
import optax
from blackhole_geodesic_calculator_tpu.camera import Camera
from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig
from blackhole_geodesic_calculator_tpu.render import RenderConfig, render_image
from blackhole_geodesic_calculator_tpu.scene import BlackHole, Scene
from blackhole_geodesic_calculator_tpu.parallel import (
    Trainer, gather_image, global_mesh, render_image_sharded,
)

v, u = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
sky = jnp.asarray(np.stack([u / 16.0, v / 8.0, np.ones_like(u, float)], -1),
                  jnp.float32)
scene = Scene(bh=BlackHole.make(mass=0.5), background=sky)
cam = Camera.make(position=(0.0, 0.0, 15.0), fov=(0.7, 0.7))
cfg = RenderConfig(width=16, height=16,
                   integrator=IntegratorConfig(n_steps=32, dt=0.2),
                   lam_max=60.0)

mesh = global_mesh()
assert mesh.devices.size == 8

# --- sharded render across both processes vs single-device reference ----
img = np.asarray(render_image_sharded(scene, cam, cfg, mesh=mesh))
ref = np.asarray(render_image(scene, cam, cfg))
err = float(np.abs(img - ref).max())
assert err < 2e-5, f"sharded-vs-single mismatch {err}"

# --- multi-process gather_image branch -----------------------------------
local = np.full((2, 4, 3), pid, np.float32)
g = gather_image(local, axis=0)
assert g.shape == (4, 4, 3), g.shape
assert (g[:2] == 0.0).all() and (g[2:] == 1.0).all()

# --- two Trainer steps: gradient psum crosses the process boundary -------
def param_fn(p):
    return (dataclasses.replace(
        scene, bh=dataclasses.replace(scene.bh, mass=p["mass"])), cam)

tr = Trainer(cfg=cfg, param_fn=param_fn, optimizer=optax.sgd(1e-2),
             mesh=mesh)
p2, losses = tr.fit({"mass": jnp.asarray(0.45)}, jnp.asarray(ref), n_steps=2)
mass2 = float(np.asarray(p2["mass"]))
# finiteness + movement are the real assertions; a 2-step SGD descent
# check would be a latent flake (a legitimate overshoot fails CI) -- the
# bit-identity cross-process checks above are the test
assert np.isfinite(losses).all()
assert mass2 != 0.45

print(f"RESULT pid={pid} err={err:.3e} "
      f"loss0={losses[0]:.8e} loss1={losses[1]:.8e} mass={mass2:.8f}")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port



def test_two_process_distributed_render_and_train(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the workers set their own XLA device-count flag and platform
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"

    # both processes must report, and agree bit-for-bit on the replicated
    # loss/params (the psum is a collective: divergence = wrong wiring)
    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert len(lines) == 1, out
        results.append(lines[0].split(" ", 1)[1])
    r0 = dict(kv.split("=") for kv in results[0].split())
    r1 = dict(kv.split("=") for kv in results[1].split())
    assert r0["loss0"] == r1["loss0"]
    assert r0["loss1"] == r1["loss1"]
    assert r0["mass"] == r1["mass"]
    assert {r0["pid"], r1["pid"]} == {"0", "1"}
