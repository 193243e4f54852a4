"""Reference-compatible frame-addressed binary field I/O.

Byte-for-byte compatible with the MATLAB direct-access format of
/root/reference/qg_flow_ray_trace/write_field.m (:31-48) and
read_field.m (:59-101): float64, column-major within a frame, frames
addressed by seeking unit*nx*ny*nz*(frame-1); complex fields stored as
staggered real/imag blocks with doubled frame stride; 1-based frame
numbers on the API (as the reference's analysis scripts use).

The heavy lifting is done by the native C++ library
(native/swrt_io.cpp) via ctypes. The shared library is not kept in git:
it is built from the source with native/Makefile on first use, and
rebuilt when the source is newer. A pure-numpy fallback serves when no
compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["write_field", "read_field", "frame_count", "native_available"]

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB = None
_LIB_TRIED = False


def _load_native():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    so = _NATIVE_DIR / "libswrt_io.so"
    src = _NATIVE_DIR / "swrt_io.cpp"
    if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.swrt_write_frame.restype = ctypes.c_int
    lib.swrt_write_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int]
    lib.swrt_read_frames.restype = ctypes.c_int
    lib.swrt_read_frames.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int]
    lib.swrt_frame_count.restype = ctypes.c_int64
    lib.swrt_frame_count.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load_native() is not None


def _binpath(fname) -> str:
    s = str(fname)
    return s if s.endswith(".bin") else s + ".bin"


def write_field(field, fname, frame: int = 1) -> None:
    """Write `field` as 1-based `frame` of fname(.bin).

    Real fields: one float64 block per frame; complex: real block then
    imag block (write_field.m:35-48). Layout within a frame is
    column-major (MATLAB fwrite order).
    """
    field = np.asarray(field)
    path = _binpath(fname)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    is_complex = np.iscomplexobj(field)
    if is_complex:
        flat = np.concatenate([
            np.ravel(field.real.astype(np.float64), order="F"),
            np.ravel(field.imag.astype(np.float64), order="F")])
        n = flat.size // 2
    else:
        flat = np.ravel(field.astype(np.float64), order="F")
        n = flat.size

    lib = _load_native()
    if lib is not None:
        buf = np.ascontiguousarray(flat)
        rc = lib.swrt_write_frame(
            path.encode(), frame,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            int(is_complex))
        if rc != 0:
            raise OSError(f"swrt_write_frame({path}, {frame}) failed: {rc}")
        return
    # numpy fallback
    stride = 2 * n if is_complex else n
    mode = "r+b" if os.path.exists(path) else "w+b"
    with open(path, mode) as fh:
        fh.seek(8 * stride * (frame - 1))
        fh.write(flat.tobytes())


def read_field(fname, nx: int = 1, ny: int = 1, nz: int = 1, frames=None,
               is_real: bool | None = None):
    """Read frames of fname(.bin); read_field.m semantics.

    nx == 1: the whole file as a 0-d time series (1-D array).
    Otherwise returns (nx, ny, nz, nframes) squeezed, column-major
    decoded. is_real defaults to the reference's heuristic
    nx == 2*ny - 1 => complex (read_field.m:37-41).
    """
    path = _binpath(fname)
    if nx == 1 and ny == 1 and nz == 1:
        return np.fromfile(path, dtype=np.float64)
    if is_real is None:
        is_real = not (nx == 2 * ny - 1)
    if frames is None:
        frames = [1]
    frames = np.atleast_1d(np.asarray(frames, np.int64))
    n = nx * ny * nz
    stride = n if is_real else 2 * n

    lib = _load_native()
    if lib is not None:
        out = np.empty(len(frames) * stride, np.float64)
        rc = lib.swrt_read_frames(
            path.encode(),
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(frames),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, int(not is_real))
        if rc != 0:
            raise OSError(f"swrt_read_frames({path}) failed: {rc}")
    else:
        out = np.empty(len(frames) * stride, np.float64)
        with open(path, "rb") as fh:
            for j, frm in enumerate(frames):
                fh.seek(8 * stride * (int(frm) - 1))
                out[j * stride:(j + 1) * stride] = np.frombuffer(
                    fh.read(8 * stride), np.float64)

    out = out.reshape(len(frames), stride)
    if is_real:
        data = out
    else:
        data = out[:, :n] + 1j * out[:, n:]
    field = np.stack([
        d.reshape((nx, ny, nz), order="F") for d in data], axis=-1)
    return np.squeeze(field)


def frame_count(fname, nx: int, ny: int = 1, nz: int = 1,
                is_real: bool = True) -> int:
    """Complete frames currently in the file (checkpoint-resume aid)."""
    path = _binpath(fname)
    n = nx * ny * nz
    lib = _load_native()
    if lib is not None:
        return int(lib.swrt_frame_count(path.encode(), n,
                                        int(not is_real)))
    if not os.path.exists(path):
        return 0
    stride = n if is_real else 2 * n
    return os.path.getsize(path) // (8 * stride)
