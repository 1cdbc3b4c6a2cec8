"""Checkpoint / resume.

The reference's durability story (SURVEY.md §5): progressive row flushing
into Blender (crash loses the current rows) and Gen-3's pickled precomputed
cameras as durable checkpoints of the expensive phase
(RelativisticRenderEngineCamEdition.py:215-221).  Standalone equivalents:

* ray fields: ``compat.RelativisticCamera.save/load`` (npz, no pickle);
* training state (inverse rendering): orbax-backed pytree checkpoints of
  (params, opt_state, step) with an npz fallback so resume works even
  where orbax is unavailable.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def save_train_state(path: str, params, opt_state, step: int) -> str:
    """Checkpoint a training pytree; directory (orbax) or .npz file."""
    if path.endswith(".npz"):
        leaves, treedef = jax.tree.flatten((params, opt_state))
        np.savez_compressed(
            path, step=np.asarray(step),
            treedef=np.frombuffer(str(treedef).encode(), np.uint8),
            **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)})
        return path
    import orbax.checkpoint as ocp

    ckpt = ocp.StandardCheckpointer()
    ckpt.save(os.path.abspath(path),
              {"params": params, "opt_state": opt_state,
               "step": np.asarray(step)},
              force=True)
    ckpt.wait_until_finished()
    return path


def load_train_state(path: str, like=None):
    """Restore (params, opt_state, step).  For .npz, ``like`` must be a
    (params, opt_state) pytree template with matching structure."""
    if path.endswith(".npz"):
        if like is None:
            raise ValueError("npz restore needs a `like` pytree template")
        with np.load(path) as z:
            step = int(z["step"])
            saved_treedef = bytes(z["treedef"]).decode()
            want_treedef = str(jax.tree.structure(like))
            if saved_treedef != want_treedef:
                raise ValueError(
                    "checkpoint treedef mismatch -- the `like` template has "
                    "a different pytree structure than what was saved "
                    "(leaves would be silently mis-assigned):\n"
                    f"  saved: {saved_treedef}\n  like:  {want_treedef}")
            leaves = [z[f"leaf_{i}"]
                      for i in range(len(jax.tree.leaves(like)))]
        params, opt_state = jax.tree.unflatten(
            jax.tree.structure(like), leaves)
        return params, opt_state, step
    import orbax.checkpoint as ocp

    ckpt = ocp.StandardCheckpointer()
    if like is not None:
        target = {"params": like[0], "opt_state": like[1],
                  "step": np.asarray(0)}
        out = ckpt.restore(os.path.abspath(path), target)
    else:
        out = ckpt.restore(os.path.abspath(path))
    return out["params"], out["opt_state"], int(out["step"])
