"""ctypes bindings for the native runtime library (C++).

The native layer is the framework's counterpart of the two compiled layers
the reference leans on: scipy's RK45 core for the per-ray ODE solves
(/root/reference/raytracer/RelativisticRenderEngine.py:293-294, README.md:196)
and Blender's C++ for image plumbing (RelativisticRenderEngine.py:78-90,
158-168).  It provides:

* ``integrate_batch`` / ``trajectory`` -- a multithreaded double-precision
  adaptive Dormand-Prince 5(4) geodesic integrator: the f64 validation
  oracle for the kernel/XLA device paths and the trajectory backend of the
  curvedpy-compat API.
* ``write_png`` / ``read_png`` / ``write_pfm`` / ``read_pfm`` -- image IO.
* ``FrameWriter`` -- an async thread-pool PNG pipeline that overlaps host
  encode/disk IO with device compute during animation renders.

The shared library builds itself on first import (g++, ~2 s) and is cached
in ``native/build/``.  Everything degrades gracefully: ``available()``
returns False when no toolchain exists and callers fall back to pure
Python/JAX paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "build", "libbgcnative.so")

_lock = threading.Lock()
_lib = None
_load_error: Exception | None = None

# Status codes -- mirror ops/states.py (asserted in tests).
(ACTIVE, CAPTURED, ESCAPED, BUDGET, DISK, OBJECT, INSIDE_HORIZON,
 ERROR) = range(8)


class _BgcEnv(ctypes.Structure):
    _fields_ = [
        ("mass", ctypes.c_double),
        ("spin", ctypes.c_double),
        ("r_capture", ctypes.c_double),
        ("r_escape", ctypes.c_double),
        ("lam_max", ctypes.c_double),
        ("disk_r_in", ctypes.c_double),
        ("disk_r_out", ctypes.c_double),
        ("spheres", ctypes.POINTER(ctypes.c_double)),
        ("n_spheres", ctypes.c_int),
    ]


class _BgcSolverOpts(ctypes.Structure):
    _fields_ = [
        ("rtol", ctypes.c_double),
        ("atol", ctypes.c_double),
        ("max_step", ctypes.c_double),
        ("min_step", ctypes.c_double),
        ("first_step", ctypes.c_double),
        ("max_evals", ctypes.c_long),
    ]


def _build() -> None:
    subprocess.run(
        ["make", "-s", "-C", _DIR, f"-j{os.cpu_count() or 2}"],
        check=True, capture_output=True, text=True,
    )


def _load():
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise _load_error
        try:
            srcs = [os.path.join(_DIR, "src", f) for f in os.listdir(
                os.path.join(_DIR, "src"))]
            if not os.path.exists(_LIB_PATH) or any(
                    os.path.getmtime(s) > os.path.getmtime(_LIB_PATH)
                    for s in srcs):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
        except Exception as e:  # toolchain missing / build failure
            _load_error = RuntimeError(f"native library unavailable: {e}")
            raise _load_error from e

        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.bgc_integrate_batch.restype = ctypes.c_int
        lib.bgc_integrate_batch.argtypes = [
            dp, dp, ctypes.c_int64,
            ctypes.POINTER(_BgcEnv), ctypes.POINTER(_BgcSolverOpts),
            ctypes.c_int, dp, dp, dp, ip, ip, ip,
        ]
        lib.bgc_trajectory.restype = ctypes.c_int
        lib.bgc_trajectory.argtypes = [
            dp, dp, ctypes.POINTER(_BgcEnv), ctypes.POINTER(_BgcSolverOpts),
            ctypes.c_int32, dp, dp, dp, ip, dp, ip,
        ]
        lib.bgc_trajectory_batch.restype = ctypes.c_int
        lib.bgc_trajectory_batch.argtypes = [
            dp, dp, ctypes.c_int64,
            ctypes.POINTER(_BgcEnv), ctypes.POINTER(_BgcSolverOpts),
            ctypes.c_int32, ctypes.c_int, dp, dp, dp, ip, dp, ip, ip, dp,
        ]
        lib.bgc_rhs.restype = None
        lib.bgc_rhs.argtypes = [dp, dp, ctypes.c_double, ctypes.c_double,
                                ctypes.c_double, dp, dp]
        lib.bgc_rhs_batch.restype = None
        lib.bgc_rhs_batch.argtypes = [dp, dp, ctypes.c_int64,
                                      ctypes.c_double, ctypes.c_double,
                                      ctypes.c_double, dp, dp]
        lib.bgc_null_init.restype = None
        lib.bgc_null_init.argtypes = [dp, dp, ctypes.c_double,
                                      ctypes.c_double, dp, dp]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.bgc_write_png.restype = ctypes.c_int
        lib.bgc_write_png.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int32,
                                      ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_int32]
        lib.bgc_read_png.restype = ctypes.c_int
        lib.bgc_read_png.argtypes = [ctypes.c_char_p, u8p, ip, ip, ip]
        fp = ctypes.POINTER(ctypes.c_float)
        lib.bgc_write_pfm.restype = ctypes.c_int
        lib.bgc_write_pfm.argtypes = [ctypes.c_char_p, fp, ctypes.c_int32,
                                      ctypes.c_int32]
        lib.bgc_read_pfm.restype = ctypes.c_int
        lib.bgc_read_pfm.argtypes = [ctypes.c_char_p, fp, ip, ip]
        lib.bgc_quantize.restype = None
        lib.bgc_quantize.argtypes = [fp, u8p, ctypes.c_int64, ctypes.c_int32,
                                     ctypes.c_int32]
        lib.bgc_writer_create.restype = ctypes.c_void_p
        lib.bgc_writer_create.argtypes = [ctypes.c_int]
        lib.bgc_writer_submit.restype = ctypes.c_int
        lib.bgc_writer_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, fp, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.bgc_writer_submit_u8.restype = ctypes.c_int
        lib.bgc_writer_submit_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, u8p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.bgc_writer_wait.restype = ctypes.c_int
        lib.bgc_writer_wait.argtypes = [ctypes.c_void_p]
        lib.bgc_writer_destroy.restype = None
        lib.bgc_writer_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    """True when the native library is (or can be) built and loaded."""
    try:
        _load()
        return True
    except Exception:
        return False


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _env_struct(*, mass, spin=None, r_capture, r_escape, lam_max,
                disk=None, spheres=None):
    env = _BgcEnv()
    env.mass = float(mass)
    env.spin = 0.0 if spin is None else float(spin)
    env.r_capture = float(r_capture)
    env.r_escape = float(r_escape)
    env.lam_max = float(lam_max)
    env.disk_r_in = float(disk[0]) if disk is not None else 0.0
    env.disk_r_out = float(disk[1]) if disk is not None else 0.0
    if spheres is not None and len(spheres):
        sph = np.ascontiguousarray(spheres, np.float64).reshape(-1, 4)
        env._sph_keepalive = sph  # prevent GC of the buffer
        env.spheres = _dp(sph)
        env.n_spheres = sph.shape[0]
    else:
        env.spheres = None
        env.n_spheres = 0
    return env


def _opts_struct(rtol=1e-8, atol=1e-10, max_step=0.0, min_step=0.0,
                 first_step=0.0, max_evals=0):
    o = _BgcSolverOpts()
    o.rtol, o.atol = float(rtol), float(atol)
    o.max_step, o.min_step = float(max_step), float(min_step)
    o.first_step, o.max_evals = float(first_step), int(max_evals)
    return o


def integrate_batch(x0, d0, *, mass, spin=None, r_capture, r_escape,
                    lam_max, disk=None, spheres=None, rtol=1e-8, atol=1e-10,
                    max_step=0.0, n_threads=0):
    """f64 oracle integration of (N, 3) ray origins/unit directions.

    Returns dict of numpy arrays: x, p (N, 3) final state; lam (N,);
    status (N,) int32 (same codes as ops/states.py); hit_obj (N,);
    n_steps (N,) accepted adaptive steps.
    """
    lib = _load()
    x0 = np.ascontiguousarray(x0, np.float64).reshape(-1, 3)
    d0 = np.ascontiguousarray(d0, np.float64).reshape(-1, 3)
    n = x0.shape[0]
    env = _env_struct(mass=mass, spin=spin, r_capture=r_capture,
                      r_escape=r_escape, lam_max=lam_max, disk=disk,
                      spheres=spheres)
    opts = _opts_struct(rtol=rtol, atol=atol, max_step=max_step)
    x = np.empty((n, 3), np.float64)
    p = np.empty((n, 3), np.float64)
    lam = np.empty((n,), np.float64)
    status = np.empty((n,), np.int32)
    hit_obj = np.empty((n,), np.int32)
    n_steps = np.empty((n,), np.int32)
    ip = ctypes.POINTER(ctypes.c_int32)
    rc = lib.bgc_integrate_batch(
        _dp(x0), _dp(d0), n, ctypes.byref(env), ctypes.byref(opts),
        int(n_threads), _dp(x), _dp(p), _dp(lam),
        status.ctypes.data_as(ip), hit_obj.ctypes.data_as(ip),
        n_steps.ctypes.data_as(ip))
    if rc != 0:
        raise RuntimeError(f"bgc_integrate_batch failed rc={rc}")
    return {"x": x, "p": p, "lam": lam, "status": status,
            "hit_obj": hit_obj, "n_steps": n_steps}


def trajectory(x0, d0, *, mass, spin=None, r_capture, r_escape, lam_max,
               disk=None, spheres=None, rtol=1e-8, atol=1e-10,
               max_step=0.0, max_points=10000):
    """One ray with the full accepted-step polyline (the reference's
    calc_trajectory output, RelativisticRenderEngine.py:293-308).

    Returns (traj_x (T, 3), traj_p (T, 3), lam_traj (T,), status, hit_obj).
    """
    lib = _load()
    x0 = np.ascontiguousarray(x0, np.float64).reshape(3)
    d0 = np.ascontiguousarray(d0, np.float64).reshape(3)
    env = _env_struct(mass=mass, spin=spin, r_capture=r_capture,
                      r_escape=r_escape, lam_max=lam_max, disk=disk,
                      spheres=spheres)
    opts = _opts_struct(rtol=rtol, atol=atol, max_step=max_step)
    tx = np.empty((max_points, 3), np.float64)
    tp = np.empty((max_points, 3), np.float64)
    tl = np.empty((max_points,), np.float64)
    n_points = ctypes.c_int32(0)
    lam_out = ctypes.c_double(0)
    hit_obj = ctypes.c_int32(-1)
    status = lib.bgc_trajectory(
        _dp(x0), _dp(d0), ctypes.byref(env), ctypes.byref(opts),
        max_points, _dp(tx), _dp(tp), _dp(tl), ctypes.byref(n_points),
        ctypes.byref(lam_out), ctypes.byref(hit_obj))
    t = n_points.value
    return tx[:t], tp[:t], tl[:t], int(status), int(hit_obj.value)


def trajectory_batch(x0, d0, *, mass, spin=None, r_capture, r_escape,
                     lam_max, disk=None, spheres=None, rtol=1e-8,
                     atol=1e-10, max_step=0.0, max_points=10000,
                     n_threads=0):
    """Dense trajectories for a WHOLE (N, 3) ray batch, multithreaded in
    C++ -- the batch form of ``trajectory`` (one ctypes crossing instead of
    N, rays solved in parallel).  Backs the compat ``calc_trajectory``
    native path for camera-scale batches.

    Returns dict: traj_x, traj_v (N, max_points, 3) f64 (positions and
    coordinate velocities dx/dlambda; per-ray valid prefix ``n_points``),
    traj_lam (N, max_points), n_points (N,) int32, lam (N,), status (N,)
    int32 (ops/states codes), hit_obj (N,), E (N,).
    """
    lib = _load()
    x0 = np.ascontiguousarray(x0, np.float64).reshape(-1, 3)
    d0 = np.ascontiguousarray(d0, np.float64).reshape(-1, 3)
    n = x0.shape[0]
    env = _env_struct(mass=mass, spin=spin, r_capture=r_capture,
                      r_escape=r_escape, lam_max=lam_max, disk=disk,
                      spheres=spheres)
    opts = _opts_struct(rtol=rtol, atol=atol, max_step=max_step)
    m = int(max_points)
    tx = np.empty((n, m, 3), np.float64)
    tv = np.empty((n, m, 3), np.float64)
    tl = np.empty((n, m), np.float64)
    n_points = np.empty((n,), np.int32)
    lam = np.empty((n,), np.float64)
    status = np.empty((n,), np.int32)
    hit_obj = np.empty((n,), np.int32)
    E = np.empty((n,), np.float64)
    ip = ctypes.POINTER(ctypes.c_int32)
    rc = lib.bgc_trajectory_batch(
        _dp(x0), _dp(d0), n, ctypes.byref(env), ctypes.byref(opts),
        m, int(n_threads), _dp(tx), _dp(tv), _dp(tl),
        n_points.ctypes.data_as(ip), _dp(lam),
        status.ctypes.data_as(ip), hit_obj.ctypes.data_as(ip), _dp(E))
    if rc != 0:
        raise RuntimeError(f"bgc_trajectory_batch failed rc={rc}")
    return {"traj_x": tx, "traj_v": tv, "traj_lam": tl,
            "n_points": n_points, "lam": lam, "status": status,
            "hit_obj": hit_obj, "E": E}


def rhs(x, p, E, mass, spin=None):
    """(dx, dp) at one state -- parity hook for ops/geodesic tests."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float64).reshape(3)
    p = np.ascontiguousarray(p, np.float64).reshape(3)
    dx = np.empty(3, np.float64)
    dp = np.empty(3, np.float64)
    lib.bgc_rhs(_dp(x), _dp(p), float(E), float(mass),
                0.0 if spin is None else float(spin), _dp(dx), _dp(dp))
    return dx, dp


def rhs_batch(x, p, E, mass, spin=None):
    """Batched (dx, dp) over (N, 3) states in ONE library call -- recovers
    the coordinate velocities of a stored trajectory polyline without a
    per-point ctypes crossing."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float64).reshape(-1, 3)
    p = np.ascontiguousarray(p, np.float64).reshape(-1, 3)
    n = x.shape[0]
    dx = np.empty((n, 3), np.float64)
    dpv = np.empty((n, 3), np.float64)
    lib.bgc_rhs_batch(_dp(x), _dp(p), n, float(E), float(mass),
                      0.0 if spin is None else float(spin), _dp(dx), _dp(dpv))
    return dx, dpv


def null_init(x, d, mass, spin=None):
    """(p, E) of a photon launched at x with unit velocity d."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float64).reshape(3)
    d = np.ascontiguousarray(d, np.float64).reshape(3)
    p = np.empty(3, np.float64)
    E = ctypes.c_double(0)
    lib.bgc_null_init(_dp(x), _dp(d), float(mass),
                      0.0 if spin is None else float(spin), _dp(p),
                      ctypes.byref(E))
    return p, E.value


def write_png(path: str, img: np.ndarray, compress_level: int = 6) -> str:
    """(H, W, 3|4) uint8 (or float in [0,1]) -> PNG via the native encoder."""
    lib = _load()
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr.astype(np.float32), 0, 1) * 255 + 0.5).astype(
            np.uint8)
    arr = np.ascontiguousarray(arr)
    h, w, c = arr.shape
    rc = lib.bgc_write_png(
        path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, c, compress_level)
    if rc != 0:
        raise RuntimeError(f"bgc_write_png failed rc={rc}")
    return path


def read_png(path: str) -> np.ndarray:
    """PNG (written by this library) -> (H, W, C) uint8."""
    lib = _load()
    ip = ctypes.POINTER(ctypes.c_int32)
    h = np.zeros(1, np.int32)
    w = np.zeros(1, np.int32)
    c = np.zeros(1, np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.bgc_read_png(path.encode(), ctypes.cast(None, u8p),
                          h.ctypes.data_as(ip), w.ctypes.data_as(ip),
                          c.ctypes.data_as(ip))
    if rc != 0:
        raise RuntimeError(f"bgc_read_png header failed rc={rc}")
    out = np.empty((int(h[0]), int(w[0]), int(c[0])), np.uint8)
    rc = lib.bgc_read_png(path.encode(), out.ctypes.data_as(u8p),
                          h.ctypes.data_as(ip), w.ctypes.data_as(ip),
                          c.ctypes.data_as(ip))
    if rc != 0:
        raise RuntimeError(f"bgc_read_png failed rc={rc}")
    return out


def write_pfm(path: str, img: np.ndarray) -> str:
    """(H, W, 3) float32 -> lossless PFM (golden-image format)."""
    lib = _load()
    arr = np.ascontiguousarray(np.asarray(img, np.float32))
    h, w, _ = arr.shape
    rc = lib.bgc_write_pfm(
        path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w)
    if rc != 0:
        raise RuntimeError(f"bgc_write_pfm failed rc={rc}")
    return path


def read_pfm(path: str) -> np.ndarray:
    lib = _load()
    ip = ctypes.POINTER(ctypes.c_int32)
    fp = ctypes.POINTER(ctypes.c_float)
    h = np.zeros(1, np.int32)
    w = np.zeros(1, np.int32)
    rc = lib.bgc_read_pfm(path.encode(), ctypes.cast(None, fp),
                          h.ctypes.data_as(ip), w.ctypes.data_as(ip))
    if rc != 0:
        raise RuntimeError(f"bgc_read_pfm header failed rc={rc}")
    out = np.empty((int(h[0]), int(w[0]), 3), np.float32)
    rc = lib.bgc_read_pfm(path.encode(), out.ctypes.data_as(fp),
                          h.ctypes.data_as(ip), w.ctypes.data_as(ip))
    if rc != 0:
        raise RuntimeError(f"bgc_read_pfm failed rc={rc}")
    return out


class FrameWriter:
    """Async PNG pipeline: ``submit`` copies the frame and returns; worker
    threads quantize/encode/write while the device renders the next frame.

    >>> with FrameWriter(threads=4) as fw:
    ...     for i, frame in enumerate(frames):
    ...         fw.submit(f"frame_{i:04d}.png", frame)
    ... # exit waits for the queue to drain
    """

    def __init__(self, threads: int = 4):
        self._lib = _load()
        self._h = self._lib.bgc_writer_create(int(threads))
        if not self._h:
            raise RuntimeError("bgc_writer_create failed")

    def submit(self, path: str, frame: np.ndarray, srgb: bool = False):
        """Queue a frame.  float frames are quantized in the worker; uint8
        frames (e.g. quantized ON DEVICE by render.render_image_u8 -- a 4x
        smaller device->host transfer) are encoded as-is (``srgb`` must
        then be pre-applied)."""
        arr = np.asarray(frame)
        if arr.ndim != 3 or arr.shape[2] not in (3, 4):
            raise ValueError(f"expected (H, W, 3|4), got {arr.shape}")
        h, w, c = arr.shape
        if arr.dtype == np.uint8:
            if srgb:
                raise ValueError("srgb tonemapping applies to float frames"
                                 " only; quantized frames are encoded"
                                 " as-is")
            arr = np.ascontiguousarray(arr)
            rc = self._lib.bgc_writer_submit_u8(
                self._h, path.encode(),
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                h, w, c)
        else:
            arr = np.ascontiguousarray(arr.astype(np.float32, copy=False))
            rc = self._lib.bgc_writer_submit(
                self._h, path.encode(),
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                h, w, c, int(srgb))
        if rc != 0:
            raise RuntimeError(f"bgc_writer_submit failed rc={rc}")

    def wait(self) -> int:
        """Drain the queue; returns the number of failed writes."""
        return int(self._lib.bgc_writer_wait(self._h))

    def close(self):
        if self._h:
            self._lib.bgc_writer_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        failures = self.wait()
        self.close()
        if failures and not exc[0]:
            raise RuntimeError(f"{failures} frame writes failed")

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
