"""Build and load the port's CUDA kernels (plain C interface, ``ctypes``).

Each source ``ops/csrc/<name>.cu`` compiles with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so <name>.cu

at first use, into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``).  ``<hash>`` covers the sources and flags, so an edited source
rebuilds and an unchanged one is reused.  :func:`build_all` starts one
``nvcc`` per source, all at once, and waits for them; nothing is built or
imported when the package is imported.  Every exported launch function
returns ``cudaGetLastError()``, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(os.environ.get(
    "GT_TORCH_BUILD_DIR",
    Path(__file__).resolve().parents[2] / "build" / "kernels"))
SOURCES = ("sampled_fwd", "layer_bwd", "encoder_fwd", "stored_fwd",
           "stored_bwd", "wide_fwd", "sampler", "recompute_bwd",
           "encoder_layer", "ffn", "fused_sampled_fwd", "mega_bwd",
           "folded_fwd", "rows_gemm", "rows_attention", "rows_ln")
NO_BUILD_ENV = "GT_TORCH_NO_BUILD"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_PARAMS = ctypes.c_void_p * 12
_FFN_PARAMS = ctypes.c_void_p * 6
# argument types of each exported function; a kernel that draws bits takes
# its seed as a device pointer (`const long long* seed`, a `_P`:
# ops/random.seed_ptr), never by value
SIGNATURES = {
    "gt_k1_sampled_fwd": [_P, _I, _P, _P, _P, _P, _P, _PARAMS, _I, _P, _P, _P,
                          _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _U,
                          _F, _I, _P],
    "gt_k2_layer_bwd": [_P, _P, _P, _P, _P, _PARAMS, _I, _I, _P, _P, _P, _I,
                        _I, _I, _I, _I, _F, _P, _U, _F, _I, _P],
    "gt_k3_slot0_bwd": [_P, _P, _P, _P, _P, _PARAMS, _I, _I, _P, _P, _P, _I,
                        _I, _I, _I, _I, _F, _P, _U, _F, _I, _P],
    "gt_k4_encoder_fwd": [_P, _I, _PARAMS, _I, _P, _I, _I, _I, _I, _I, _I,
                          _F, _P, _U, _F, _I, _P],
    "gt_k4w_encoder_fwd": [_P, _I, _PARAMS, _I, _P, _I, _I, _I, _I, _I, _I,
                           _F, _P, _U, _F, _I, _P],
    "gt_k5_stored_fwd": [_P, _I, _P, _P, _P, _P, _P, _PARAMS, _I, _P, _P, _P,
                         _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                         _P, _U, _F, _I, _P],
    "gt_k6_layer_bwd": [_P, _I, _P, _P, _P, _P, _P, _PARAMS, _I, _I, _P, _P,
                        _P, _I, _I, _I, _I, _I, _F, _P, _U, _F, _I, _P],
    "gt_k6_slot0_bwd": [_P, _I, _P, _P, _P, _P, _P, _PARAMS, _I, _I, _P, _P,
                        _P, _I, _I, _I, _I, _I, _F, _P, _U, _F, _I, _P],
    "gt_k7_sample": [_P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P,
                     _P],
    "gt_k4t_encoder_fwd": [_P, _I, _PARAMS, _I, _P, _P, _I, _I, _I, _I, _I,
                           _I, _F, _P, _U, _F, _I, _P],
    "gt_k8_layer_bwd": [_P, _I, _P, _PARAMS, _I, _I, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _F, _P, _U, _F, _I, _P],
    "gt_k8s_slot0_bwd": [_P, _I, _P, _PARAMS, _I, _I, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _F, _P, _U, _F, _I, _P],
    "gt_k9_layer_fwd": [_P, _I, _P, _PARAMS, _I, _I, _I, _I, _I, _I, _F, _P,
                        _U, _F, _I, _P],
    "gt_k10_layer_bwd": [_P, _I, _P, _PARAMS, _I, _P, _P, _P, _P, _P, _P, _I,
                         _I, _I, _I, _I, _F, _P, _U, _F, _I, _P],
    "gt_k4tw_encoder_fwd": [_P, _I, _PARAMS, _I, _P, _P, _I, _I, _I, _I, _I,
                            _I, _F, _P, _U, _F, _I, _P],
    "gt_k8w_layer_bwd": [_P, _I, _P, _PARAMS, _I, _I, _P, _P, _P, _I, _I, _I,
                         _I, _I, _F, _P, _U, _F, _I, _P],
    "gt_k8ws_slot0_bwd": [_P, _I, _P, _PARAMS, _I, _I, _P, _P, _P, _I, _I, _I,
                          _I, _I, _F, _P, _U, _F, _I, _P],
    "gt_k9w_layer_fwd": [_P, _I, _P, _PARAMS, _I, _I, _I, _I, _I, _I, _F, _P,
                         _U, _F, _I, _P],
    "gt_k10w_layer_bwd": [_P, _I, _P, _PARAMS, _I, _P, _P, _P, _I, _I, _I, _I,
                          _I, _F, _P, _U, _F, _I, _P],
    "gt_k13_sampled_fwd": [_P, _I, _P, _P, _P, _P, _P, _PARAMS, _I, _P, _P, _I,
                           _I, _I, _I, _I, _I, _F, _P, _U, _F, _I, _P],
    "gt_k11_ffn_fwd": [_P, _I, _P, _FFN_PARAMS, _I, _I, _I, _I, _P, _U, _F,
                       _I, _P],
    "gt_k12_ffn_bwd": [_P, _I, _P, _FFN_PARAMS, _I, _P, _P, _P, _I, _I, _I,
                       _P, _U, _F, _I, _P],
    "gt_wgrad": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "gt_k14_mega_bwd": [_P, _P, _I, _P, _PARAMS, _I, _P, _P, _P, _P, _P, _P,
                        _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _U, _F, _I,
                        _P],
    "gt_k14w_mega_bwd": [_P, _P, _I, _P, _PARAMS, _I, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _F, _P, _U, _F, _I, _P],
    "gt_k15_folded_stored_fwd": [_P, _PARAMS, _I, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _F, _P, _U, _F, _I,
                                 _P],
    "gt_k16_folded_fwd": [_P, _PARAMS, _I, _P, _I, _I, _I, _I, _I, _I, _F, _P,
                          _U, _F, _I, _P],
    "gt_k17_stored_rows_fwd": [_P, _I, _PARAMS, _I, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P,
                               _U, _F, _I, _P],
    "gt_k18_gemm": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                    _P, _I, _P, _P, _F, _I, _P, _U, _U, _F, _I, _I, _P, _P,
                    _P],
    "gt_k18_colsum": [_P, _I, _P, _P, _I, _I, _I, _I, _P],
    "gt_k19_attn_fwd": [_P, _P, _I, _I, _I, _I, _I, _F, _P, _U, _U, _F, _I,
                        _P],
    "gt_k19_attn_bwd": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _U, _U, _F,
                        _I, _P],
    "gt_k20_ln_fwd": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _U, _U, _F, _I,
                      _P],
    "gt_k20_ln_bwd": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _P, _U, _U, _F, _I, _P],
}
# integer-valued helpers: K18's chunk counts (M, N, K, bf16) and (rows),
# K20's backward blocks (R, D)
COUNT_FNS = {"gt_k18_chunks": 4, "gt_k18_colsum_chunks": 1,
             "gt_k20_bwd_blocks": 2}
# scratch bytes: K6, K8w/K10w (N, S, D, F, G, slot0, bf16), K12 (M, D, F,
# bf16), K14w (N, S, D, F, G, T, bf16), K18's bf16 packed tiles (M, N, K)
# -> bytes; the split-K products' scratch (rows, M1, N1) -> floats
WORK_FNS = {"gt_k6_work_bytes": 7, "gt_k8w_work_bytes": 7,
            "gt_k10w_work_bytes": 7, "gt_k12_work_bytes": 4,
            "gt_k14w_work_bytes": 7, "gt_k18_bf16_scratch": 3,
            "gt_wgrad_split_floats": 3}
# each kernel's shared memory per block, (G, S, D) -> bytes
SMEM_FNS = ("gt_k1_smem_bytes", "gt_k2_smem_bytes", "gt_k3_smem_bytes",
            "gt_k4_smem_bytes", "gt_k4w_smem_bytes", "gt_k5_smem_bytes",
            "gt_k6_smem_bytes", "gt_k6s_smem_bytes", "gt_k8_smem_bytes",
            "gt_k8s_smem_bytes", "gt_k9_smem_bytes", "gt_k10_smem_bytes",
            "gt_k8w_smem_bytes", "gt_k8ws_smem_bytes", "gt_k9w_smem_bytes",
            "gt_k10w_smem_bytes", "gt_k13_smem_bytes", "gt_k13w_smem_bytes",
            "gt_k14_smem_bytes", "gt_k14w_smem_bytes", "gt_k15_smem_bytes",
            "gt_k17_smem_bytes")

_libs: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def nvcc_command(src, out) -> list:
    """The ``nvcc`` command that builds the source ``src`` (headers from
    ``csrc/``) into the library ``out``, with ptxas's register report."""
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-Xptxas", "-v", "-o",
            str(out), str(src)]


def build_all(names=SOURCES, verbose: bool = False) -> float:
    """Compile every missing library, one ``nvcc`` per source in parallel;
    returns the seconds it took.  Raises with the compiler's output on a
    failure."""
    import time

    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(CSRC / f"{name}.cu", tmp)
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log = p.communicate()[0]
        if p.returncode != 0:
            failed.append(f"--- {name} (rc {p.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        if verbose:
            print(f"# nvcc {name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The library of source ``name``, built first if missing (with
    ``GT_TORCH_NO_BUILD`` set, as in the ranks ``parallel/launch.py``
    spawns after building in the parent, a missing library raises)."""
    lib = _libs.get(name)
    if lib is None:
        if not lib_path(name).exists():
            if os.environ.get(NO_BUILD_ENV):
                raise RuntimeError(f"{lib_path(name)} is not built and "
                                   f"{NO_BUILD_ENV} forbids building it here")
            build_all()
        lib = _libs[name] = open_lib(lib_path(name))
    return lib


def open_lib(path) -> ctypes.CDLL:
    """The library at ``path`` with its exported functions' types set."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    for fn in SMEM_FNS:
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = [_I, _I, _I]
            getattr(lib, fn).restype = ctypes.c_size_t
    for fn, nargs in WORK_FNS.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = [_I] * nargs
            getattr(lib, fn).restype = ctypes.c_size_t
    for fn, nargs in COUNT_FNS.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = [_I] * nargs
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def f32_params(tensors) -> list:
    """Parameters as the kernels read them: detached, float32, contiguous."""
    return [t.detach().float().contiguous() for t in tensors]


def check_rows_dtype(x) -> None:
    """The kernels take rows in bfloat16 or float32."""
    import torch

    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"rows dtype {x.dtype}: bfloat16 or float32 only")


def params_array(tensors) -> ctypes.Array:
    """The pointers of the 12 encoder tensors (6 for the FFN kernels)."""
    kind = _PARAMS if len(tensors) == 12 else _FFN_PARAMS
    return kind(*[t.data_ptr() for t in tensors])


# blocks that fill the H100: two on each of its 132 SMs
FILL_BLOCKS = 264
# rows a block of the thread-per-row forward layer holds at most: its
# GT_BWD_THREADS threads (csrc/common.cuh), a thread per row
FWD_ROWS = 256


def fill_groups(S: int, rows: int = 128, n: int = 0,
                whole_waves: bool = False) -> int:
    """Neighborhoods per block before shared memory has its say: up to
    ``rows`` rows; with ``n`` neighborhoods given, ceil(n / FILL_BLOCKS) at
    most, so that the grid has about FILL_BLOCKS blocks or more.  With
    ``whole_waves``, the grid fills the fewest waves of FILL_BLOCKS blocks
    that blocks of up to ``rows`` rows can, each wave as full as it can be:
    ceil(n / (waves * FILL_BLOCKS)) neighborhoods a block."""
    G = max(1, rows // S)
    if n:
        waves = -(-n // (G * FILL_BLOCKS)) if whole_waves else 1
        G = max(1, min(G, -(-n // (waves * FILL_BLOCKS))))
    return G


def pick_groups(name: str, smem_fn: str, S: int, D: int, rows: int = 128,
                limit: int = 200 * 1024, n: int = 0,
                whole_waves: bool = False) -> int:
    """Neighborhoods per block of the kernel whose shared memory ``smem_fn``
    of source ``name`` gives: :func:`fill_groups`, fewer if shared memory
    asks."""
    smem = getattr(load(name), smem_fn)
    G = fill_groups(S, rows, n, whole_waves)
    while G > 1 and smem(G, S, D) > limit:
        G -= 1
    if smem(G, S, D) > limit:
        raise NotImplementedError(
            f"{smem_fn}: S={S}, D={D} needs more shared memory than a block has")
    return G


def pick_fwd_groups(name: str, smem_fn: str, S: int, D: int, n: int) -> int:
    """Neighborhoods per block of a launch of the thread-per-row forward
    layer (K1, K4, K4t, K9, K13, K15-K17 up to D=32) over ``n``
    neighborhoods: up to FWD_ROWS rows a block, in whole waves (at the
    bench's 8,832 x S=9: 17 a block, 520 blocks in two waves of 264, where
    128-row blocks made 631, three waves with the last 39% full)."""
    return pick_groups(name, smem_fn, S, D, FWD_ROWS, n=n, whole_waves=True)


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
