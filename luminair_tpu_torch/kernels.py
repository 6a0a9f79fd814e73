"""The port's hand-written Hopper kernels: build, binding, wrappers.

The CUDA C++ sources under csrc/ (sharing csrc/m31.cuh and csrc/tape.cuh)
are compiled at first use with nvcc for sm_90a, one shared library per
source, all sources compiled at once, into build/kernels/ at the repository
root; each library is named by a hash of its source and every header it
includes, so an edit to either rebuilds it.  The libraries
have a plain C interface bound with ctypes: every entry point launches on
PyTorch's current stream, allocates nothing, and returns
cudaGetLastError(), which the wrapper turns into a KernelError.

Every wrapper has a plain PyTorch twin here (`*_plain`).  A wrapper takes
the twin only for tensors that lie on the CPU; for CUDA tensors it launches
its kernel or raises.  Each kernel counts its launches (`Kernel.launches`),
so a run can show that its path went through the kernel.

Storage: int32 tensors holding the reference's uint32 words; the kernels
read the same buffers as uint32.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from . import circle
from . import fields as f
from .crypto import blake2s
from .errors import KernelError

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_U = ctypes.c_uint32


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(source: str) -> List[Path]:
    """The source and every csrc/ header it includes, directly or not."""
    seen, todo = [], [_CSRC / source]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.append(p)
        todo.extend(_CSRC / name for name in _INCLUDE.findall(p.read_text()))
    return seen


class Kernel:
    """One kernel: its CUDA source, C entry points, and a count of launches.
    `abi` maps C functions without arguments to the value each must return:
    the size of a struct passed by value, or a limit that this module and
    the source both use; checked when the library loads."""

    def __init__(self, name: str, source: str, replaces: str, symbols: Dict[str, list],
                 abi: Optional[Dict[str, int]] = None):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.symbols = symbols
        self.abi = abi or {}
        self.launches = 0
        self._fns = None

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in _sources(self.source):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return BUILD_DIR / f"{Path(self.source).stem}-{h.hexdigest()[:16]}.so"

    def _load(self):
        with _LOAD_LOCK:
            if self._fns is None:
                path = self.library_path()
                if not path.exists():
                    build()
                lib = ctypes.CDLL(str(path))
                for sym, want in self.abi.items():
                    fn = getattr(lib, sym)
                    fn.argtypes, fn.restype = [], ctypes.c_longlong
                    if fn() != want:
                        raise KernelError(f"{self.name}: {sym}() is {fn()} in {self.source}, {want} here")
                fns = {}
                for sym, argtypes in self.symbols.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes + [_P]  # ... , stream
                    fn.restype = ctypes.c_int
                    fns[sym] = fn
                self._fns = fns
        return self._fns

    def launch(self, symbol: str, device: torch.device, *args):
        fn = self._load()[symbol]
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise KernelError(f"{self.name}.{symbol}: CUDA error {err} at launch")
        self.launches += 1


_LOAD_LOCK = threading.Lock()

CIRCLE_FFT = Kernel(
    "circle_fft",
    "fft.cu",
    "luminair_tpu/parallel/accel.py:718 (_jit_lde; fft.ifft :248, fft.fft :305)",
    {
        "lum_fft_stage": [_P, _P, _P, _LL, _I, _I, _I],
        "lum_fft_embed": [_P, _P, _LL, _I, _I, _I],
    },
)
MERKLE = Kernel(
    "blake2s_merkle",
    "merkle.cu",
    "luminair_tpu/parallel/accel.py:853 (_jit_merkle_tree; blake2s.hash_words :134)",
    {"lum_merkle_layer": [_P, _P, _I, _LL, _LL, _P, _LL]},
)
FRI_FOLD = Kernel(
    "fri_fold",
    "fri.cu",
    "luminair_tpu/parallel/accel.py:1299 (_jit_fold_circle; _jit_fold_line :1314)",
    {"lum_fri_fold": [_P, _P, _P, _P] + [_U] * 8 + [_LL]},
)
DEEP_QUOTIENT = Kernel(
    "deep_quotient",
    "quotient.cu",
    "luminair_tpu/parallel/accel.py:1248 (_jit_quotient_group)",
    {"lum_deep_quotient": [_P, _P, _I, _P, _P, _P, _P, _LL, _I]},
)

# The tape's kernel ABI (csrc/tape.cuh): lookup-element kinds in the order
# of the elements table, and the limits the kernels are compiled for
# (air/tape.py checks them when it records a component).
ELEM_KINDS = ("node", "sin", "exp2", "log2", "range_check")
TAPE_MAX_REGS = 16
TAPE_MAX_MAIN = 32
TAPE_MAX_PP = 4
TAPE_MAX_RELATIONS = 8
TAPE_MAX_POWS = 32
TAPE_MAX_INS = 128


class AirArgs(ctypes.Structure):
    """Mirror of lum::AirArgs (csrc/tape.cuh), passed to K5/K6 by value."""

    _fields_ = [
        ("main", ctypes.c_uint64 * TAPE_MAX_MAIN),
        ("pp", ctypes.c_uint64 * TAPE_MAX_PP),
        ("inter", ctypes.c_uint64 * (4 * TAPE_MAX_RELATIONS)),
        ("is_first", ctypes.c_uint64),
        ("xs", ctypes.c_uint64),
        ("out", ctypes.c_uint64),
        ("tape", ctypes.c_uint64),
        ("n", ctypes.c_longlong),
        ("n_ins", ctypes.c_int),
        ("n_rel", ctypes.c_int),
        ("n_constraints", ctypes.c_int),
        ("stride", ctypes.c_int),
        ("log_trace", ctypes.c_int),
        ("accumulate", ctypes.c_int),
        ("elems", ctypes.c_uint32 * (len(ELEM_KINDS) * 2 * 4)),
        ("claimed", ctypes.c_uint32 * 4),
        ("pows", ctypes.c_uint32 * (4 * TAPE_MAX_POWS)),
    ]


OODS_MAX_COLS = 256
OODS_MAX_LOG = 32
OODS_CHUNK_LOG = 11


class OodsArgs(ctypes.Structure):
    """Mirror of OodsArgs (csrc/oods.cu), passed to K7 by value."""

    _fields_ = [
        ("cols", ctypes.c_uint64 * OODS_MAX_COLS),
        ("chain", ctypes.c_uint32 * (4 * OODS_MAX_LOG)),
        ("n_cols", ctypes.c_int),
        ("log_n", ctypes.c_int),
    ]


_AIR_ABI = {
    "lum_air_args_size": ctypes.sizeof(AirArgs),
    "lum_tape_max_regs": TAPE_MAX_REGS,
    "lum_tape_max_ins": TAPE_MAX_INS,
}

AIR_WITNESS = Kernel(
    "air_witness",
    "air.cu",
    "luminair_tpu/parallel/accel.py:1068 (_jit_witness; WitnessEval.build_interaction)",
    {"lum_air_witness": [_P], "lum_m31_scan": [_P, _LL, _I, _P]},
    abi=_AIR_ABI,
)
AIR_DOMAIN = Kernel(
    "air_domain",
    "air.cu",
    "luminair_tpu/parallel/accel.py:1112 (_jit_domain; DomainEval)",
    {"lum_air_domain": [_P]},
    abi=_AIR_ABI,
)
OODS_EVAL = Kernel(
    "oods_eval",
    "oods.cu",
    "luminair_tpu/parallel/accel.py:1792 (_jit_eval_at_point; fft.eval_at_point_many)",
    {"lum_oods_eval": [_P, _P, _P]},
    abi={"lum_oods_args_size": ctypes.sizeof(OodsArgs), "lum_oods_chunk_log": OODS_CHUNK_LOG},
)

KERNELS = (CIRCLE_FFT, MERKLE, FRI_FOLD, DEEP_QUOTIENT, AIR_WITNESS, AIR_DOMAIN, OODS_EVAL)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the kernels are built on a machine with the CUDA toolkit")


def build() -> Dict[str, str]:
    """Compile every kernel library that is missing, one nvcc process per
    source, all started together.  Returns {source: ptxas report}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for k in KERNELS:
        out = k.library_path()
        if out.exists() or k.source in jobs:
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(_CSRC / k.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[k.source] = (out, tmp, proc)
    reports, errors = {}, []
    for source, (out, tmp, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{source}:\n{stderr}{stdout}")
            continue
        os.replace(tmp, out)
        reports[source] = stderr + stdout
    if errors:
        raise KernelError("kernel build failed:\n" + "\n".join(errors))
    return reports


def load_all() -> None:
    """Build (if needed) and load every kernel library."""
    build()
    for k in KERNELS:
        k._load()


# ---------------------------------------------------------------------------
# Shared checks.


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise KernelError(f"unsupported device {t.device}")


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise KernelError(what)


def _log2(n: int) -> int:
    log = n.bit_length() - 1
    _require(n > 0 and 1 << log == n, f"length {n} is not a power of two")
    return log


def _check_cols(t: torch.Tensor, name: str) -> None:
    _require(t.dtype == f.I32, f"{name}: expected int32, got {t.dtype}")
    _require(t.dim() == 2, f"{name}: expected (columns, rows), got {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# K1: circle FFT.


def _run_stages(src: torch.Tensor, log_ms: List[int], inverse: bool, scratch: Optional[torch.Tensor]):
    """Launch one stage per block log in `log_ms`, ping-ponging between a
    new buffer and `scratch` (a second new buffer when None; `src` itself
    when the caller lets it be overwritten)."""
    n_cols, n = src.shape
    log_n = _log2(n)
    bufs = [torch.empty_like(src), scratch if scratch is not None else torch.empty_like(src)]
    cur = src
    for i, log_m in enumerate(log_ms):
        dst = bufs[i % 2]
        tw = circle.twiddle_stage(log_n, log_n - log_m, inverse, src.device)
        CIRCLE_FFT.launch(
            "lum_fft_stage", src.device, cur.data_ptr(), dst.data_ptr(), tw.data_ptr(),
            n_cols, log_n, log_m, int(inverse),
        )
        cur = dst
    return cur


def circle_ifft(values: torch.Tensor) -> torch.Tensor:
    """Interpolate (C, N) domain values into (C, N) circle coefficients."""
    _check_cols(values, "circle_ifft")
    if _on_cpu(values):
        return circle_ifft_plain(values)
    log_n = _log2(values.shape[1])
    if log_n == 0:
        return values.clone()
    return _run_stages(values.contiguous(), list(range(log_n, 0, -1)), True, None)


def circle_fft(coeffs: torch.Tensor, m_start: int = 2) -> torch.Tensor:
    """Evaluate (C, N) coefficients on the domain; stages with block size
    below m_start are skipped (the input already holds their output)."""
    _check_cols(coeffs, "circle_fft")
    if _on_cpu(coeffs):
        return circle_fft_plain(coeffs, m_start)
    log_n = _log2(coeffs.shape[1])
    log_ms = list(range(_log2(m_start), log_n + 1))
    if not log_ms:
        return coeffs.clone()
    return _run_stages(coeffs.contiguous(), log_ms, False, None)


def circle_lde(coeffs: torch.Tensor, log_blowup: int) -> torch.Tensor:
    """Evaluate (C, n) coefficients on the 2^log_blowup times larger domain."""
    _check_cols(coeffs, "circle_lde")
    if _on_cpu(coeffs):
        return circle_lde_plain(coeffs, log_blowup)
    n_cols, n = coeffs.shape
    log_big = _log2(n) + log_blowup
    duplicate = log_blowup == 1 and n > 1
    ext = torch.empty((n_cols, 1 << log_big), dtype=f.I32, device=coeffs.device)
    CIRCLE_FFT.launch(
        "lum_fft_embed", coeffs.device, coeffs.contiguous().data_ptr(), ext.data_ptr(),
        n_cols, log_big, log_blowup, int(duplicate),
    )
    log_ms = list(range(2 if duplicate else 1, log_big + 1))
    return _run_stages(ext, log_ms, False, ext)


def circle_ifft_plain(values: torch.Tensor) -> torch.Tensor:
    a = values.to(f.I64)
    n_cols, n = a.shape
    log_n = _log2(n)
    for s in range(log_n):
        m = n >> s
        t = circle.twiddle_stage(log_n, s, True, a.device).to(f.I64)
        blocks = a.reshape(n_cols, n // m, m)
        v0 = blocks[..., : m // 2]
        v1 = blocks[..., m // 2 :].flip(-1)
        e = f.mul(f.add(v0, v1), f.INV2)
        o = f.mul(f.sub(v0, v1), t)
        a = torch.cat([e, o], dim=-1).reshape(n_cols, n)
    return a.to(f.I32)


def circle_fft_plain(coeffs: torch.Tensor, m_start: int = 2) -> torch.Tensor:
    a = coeffs.to(f.I64)
    n_cols, n = a.shape
    log_n = _log2(n)
    m = m_start
    while m <= n:
        t = circle.twiddle_stage(log_n, log_n - _log2(m), False, a.device).to(f.I64)
        blocks = a.reshape(n_cols, n // m, m)
        e = blocks[..., : m // 2]
        to = f.mul(t, blocks[..., m // 2 :])
        a = torch.cat([f.add(e, to), f.sub(e, to).flip(-1)], dim=-1).reshape(n_cols, n)
        m *= 2
    return a.to(f.I32)


def circle_lde_plain(coeffs: torch.Tensor, log_blowup: int) -> torch.Tensor:
    n_cols, n = coeffs.shape
    if log_blowup == 1 and n > 1:
        # [c, 0] -> [c, c] is the first forward stage on the zero embedding.
        dup = torch.stack([coeffs, coeffs], dim=-1).reshape(n_cols, 2 * n)
        return circle_fft_plain(dup, m_start=4)
    ext = torch.zeros((n_cols, n << log_blowup), dtype=f.I32, device=coeffs.device)
    ext[:, :: 1 << log_blowup] = coeffs
    return circle_fft_plain(ext)


# ---------------------------------------------------------------------------
# K2: Blake2s Merkle layer.


def merkle_layer(prev: Optional[torch.Tensor], cols: Optional[torch.Tensor]) -> torch.Tensor:
    """Digests (n, 8) of node i = H(prev[2i] || prev[2i+1] || cols[:, i]).

    prev: (2n, 8) int32 child digests or None (leaf layer); cols: a (k, n)
    int32 view, any strides, or None."""
    ref = prev if prev is not None else cols
    _require(ref is not None, "merkle_layer: no input")
    if cols is not None:
        _check_cols(cols, "merkle_layer cols")
        n = cols.shape[1]
    else:
        n = prev.shape[0] // 2
    if prev is not None:
        _require(
            prev.dtype == f.I32 and tuple(prev.shape) == (2 * n, 8) and prev.is_contiguous(),
            f"merkle_layer: prev must be contiguous int32 ({2 * n}, 8)",
        )
    if _on_cpu(ref):
        return merkle_layer_plain(prev, cols)
    out = torch.empty((n, 8), dtype=f.I32, device=ref.device)
    k, sk, sn = (cols.shape[0], cols.stride(0), cols.stride(1)) if cols is not None else (0, 0, 0)
    MERKLE.launch(
        "lum_merkle_layer", ref.device,
        prev.data_ptr() if prev is not None else None,
        cols.data_ptr() if cols is not None else None,
        k, sk, sn, out.data_ptr(), n,
    )
    return out


def merkle_layer_plain(prev: Optional[torch.Tensor], cols: Optional[torch.Tensor]) -> torch.Tensor:
    parts = []
    if prev is not None:
        parts.append(prev.reshape(-1, 16))
    if cols is not None:
        parts.append(cols.t())
    return blake2s.hash_words_plain(torch.cat(parts, dim=1))


# ---------------------------------------------------------------------------
# K3: FRI fold.


def _words(x) -> List[int]:
    try:
        return list(f.qm31_words(x))
    except ValueError as e:
        raise KernelError(str(e)) from None


def fri_fold(values: torch.Tensor, twiddles: torch.Tensor, alpha, mix: Optional[torch.Tensor] = None,
             beta2=None) -> torch.Tensor:
    """(2n, 4) QM31 -> (n, 4): (v0+v1)/2 + alpha*(v0-v1)*tw over the pairs
    (i, 2n-1-i), plus beta2*mix when `mix` is given."""
    _require(values.dtype == f.I32 and values.dim() == 2 and values.shape[1] == 4,
             "fri_fold: values must be int32 (2n, 4)")
    n = values.shape[0] // 2
    _require(tuple(twiddles.shape) == (n,) and twiddles.dtype == f.I32, "fri_fold: twiddles (n,) int32")
    if mix is not None:
        _require(tuple(mix.shape) == (n, 4) and mix.dtype == f.I32, "fri_fold: mix (n, 4) int32")
    a = _words(alpha)
    b = _words(beta2) if mix is not None else [0, 0, 0, 0]
    if _on_cpu(values):
        return fri_fold_plain(values, twiddles, a, mix, b)
    values = values.contiguous()
    twiddles = twiddles.contiguous()
    mix = mix.contiguous() if mix is not None else None
    out = torch.empty((n, 4), dtype=f.I32, device=values.device)
    FRI_FOLD.launch(
        "lum_fri_fold", values.device, values.data_ptr(), out.data_ptr(), twiddles.data_ptr(),
        mix.data_ptr() if mix is not None else None, *a, *b, n,
    )
    return out


def fri_fold_plain(values, twiddles, alpha, mix=None, beta2=None) -> torch.Tensor:
    dev = values.device
    v = values.to(f.I64)
    n = v.shape[0] // 2
    v0, v1 = v[:n], v[n:].flip(0)
    e = f.mul(f.add(v0, v1), f.INV2)
    o = f.mul(f.sub(v0, v1), twiddles.to(f.I64)[:, None])
    r = f.add(e, f.qm31_mul(torch.tensor(_words(alpha), dtype=f.I64, device=dev), o))
    if mix is not None:
        b2 = torch.tensor(_words(beta2), dtype=f.I64, device=dev)
        r = f.add(r, f.qm31_mul(b2, mix.to(f.I64)))
    return r.to(f.I32)


# ---------------------------------------------------------------------------
# K4: DEEP quotient group.


def deep_quotient(cols: Sequence[torch.Tensor], gammas: torch.Tensor, consts: torch.Tensor,
                  log: int, acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quotient (2^log, 4) of one sample group on D_log (see quotient.cu).

    cols: S int32 (2^log,) columns; gammas (S, 4) and consts (5, 4) = A, B,
    C, acc_a, acc_c0 as int64 QM31.  With `acc`, returns acc + quotient (the
    kernel adds into `acc` in place)."""
    n = 1 << log
    _require(len(cols) == gammas.shape[0] and len(cols) > 0, "deep_quotient: one gamma per column")
    for c in cols:
        _require(c.dtype == f.I32 and tuple(c.shape) == (n,), f"deep_quotient: columns must be int32 ({n},)")
    _require(tuple(consts.shape) == (5, 4), "deep_quotient: consts (5, 4)")
    if acc is not None:
        _require(acc.dtype == f.I32 and tuple(acc.shape) == (n, 4) and acc.is_contiguous(),
                 "deep_quotient: acc (n, 4) contiguous int32")
    dev = cols[0].device
    if _on_cpu(cols[0]):
        return deep_quotient_plain(cols, gammas, consts, log, acc)
    cols = [c.contiguous() for c in cols]
    ptrs = torch.tensor([c.data_ptr() for c in cols], dtype=f.I64).to(dev)
    g = gammas.to(f.I32).contiguous().to(dev)
    k = consts.to(f.I32).contiguous().to(dev)
    xs, ys = circle.domain_table(log, dev)
    out = acc if acc is not None else torch.empty((n, 4), dtype=f.I32, device=dev)
    DEEP_QUOTIENT.launch(
        "lum_deep_quotient", dev, ptrs.data_ptr(), g.data_ptr(), len(cols), xs.data_ptr(),
        ys.data_ptr(), k.data_ptr(), out.data_ptr(), n, int(acc is not None),
    )
    return out


def deep_quotient_plain(cols, gammas, consts, log: int, acc=None) -> torch.Tensor:
    dev = cols[0].device
    xs, ys = (t.to(f.I64) for t in circle.domain_table(log, dev))
    g = gammas.to(f.I64).to(dev)
    A, B, C, acc_a, acc_c0 = consts.to(f.I64).to(dev).unbind(0)
    den = f.add(f.sub(f.qm31_mul_m31(A, xs), f.qm31_mul_m31(B, ys)), C)
    num = f.qm31_zero((1 << log,), dev)
    for j, c in enumerate(cols):
        num = f.add(num, f.qm31_mul_m31(g[j], c.to(f.I64)))
    num = f.sub(f.sub(num, f.qm31_mul_m31(acc_a, xs)), acc_c0)
    q = f.qm31_mul(num, f.qm31_inv(den))
    if acc is not None:
        q = f.add(acc.to(f.I64), q)
    return q.to(f.I32)


# ---------------------------------------------------------------------------
# K5 / K6: the component tape on the trace domain and on the commit domain.


def _check_rows(cols: Sequence[torch.Tensor], n: int, what: str) -> None:
    for c in cols:
        _require(c.dtype == f.I32 and tuple(c.shape) == (n,), f"{what}: columns must be int32 ({n},)")


def _ptrs(cols: Sequence[torch.Tensor], device: torch.device) -> List[int]:
    for c in cols:
        _require(c.device == device and c.is_contiguous(), "columns must be contiguous, on one device")
    return [c.data_ptr() for c in cols]


def _air_args(tp, main, pp, ew, n: int, dev: torch.device) -> AirArgs:
    a = AirArgs()
    a.main[: len(main)] = _ptrs(main, dev)
    a.pp[: len(pp)] = _ptrs(pp, dev)
    a.tape = tp.tensor(dev).data_ptr()
    a.n, a.n_ins, a.n_rel, a.n_constraints = n, tp.n_ins, tp.n_relations, tp.n_constraints
    a.elems[:] = [w for kind in ew for q in kind for w in q]
    return a


def air_witness(tp, main: Sequence[torch.Tensor], pp: Sequence[torch.Tensor], ew):
    """The LogUp interaction of one component on its trace domain: (4E, N)
    int32 -- row 4b + k is coordinate k of entry b, the last entry summed
    down the rows -- and the claimed sum (4,) int32 (see air.cu).

    main / pp: the component's padded columns, int32 (N,), in MAIN / PP_IDS
    order; ew: `tape.element_words` of the drawn lookup elements."""
    _require(len(main) == tp.n_main and len(pp) == tp.n_pp, f"air_witness({tp.name}): column count")
    ref = (list(main) + list(pp))[0]
    n = ref.shape[0]
    _log2(n)
    _check_rows(list(main) + list(pp), n, "air_witness")
    if _on_cpu(ref):
        from .air import tape as tp_mod

        return tp_mod.witness_plain(tp, main, pp, ew)
    dev = ref.device
    out = torch.empty((4 * tp.n_relations, n), dtype=f.I32, device=dev)
    a = _air_args(tp, main, pp, ew, n, dev)
    a.out, a.stride = out.data_ptr(), 1
    AIR_WITNESS.launch("lum_air_witness", dev, ctypes.addressof(a))
    last = out[-4:]
    sums = torch.empty(4 * ((n + 1023) // 1024), dtype=f.I32, device=dev)
    AIR_WITNESS.launch("lum_m31_scan", dev, last.data_ptr(), n, 4, sums.data_ptr())
    return out, last[:, -1]


def air_domain(tp, main, pp, inter, is_first: torch.Tensor, claimed, ew, pows, log_trace: int,
               stride: int, acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Constraint quotients (M, 4) int32 of one component on its commit
    domain D_log, M = 2^log (see air.cu); with `acc`, acc + quotients (the
    kernel adds into `acc` in place).

    main / pp: commit-domain evaluations int32 (M,) in MAIN / PP_IDS order;
    inter: the 4E interaction coordinates; claimed: 4 words; pows: the
    component's K + E alpha powers (`fields.qm31_powers_ints`)."""
    m = is_first.shape[0]
    log = _log2(m)
    _require(len(main) == tp.n_main and len(pp) == tp.n_pp and len(inter) == 4 * tp.n_relations,
             f"air_domain({tp.name}): column count")
    _require(len(pows) == tp.n_pows, f"air_domain({tp.name}): {tp.n_pows} alpha powers")
    _require(0 < stride < m and log_trace >= 1, "air_domain: bad stride or trace log")
    _check_rows(list(main) + list(pp) + list(inter) + [is_first], m, "air_domain")
    if acc is not None:
        _require(acc.dtype == f.I32 and tuple(acc.shape) == (m, 4) and acc.is_contiguous(),
                 "air_domain: acc (M, 4) contiguous int32")
    if _on_cpu(is_first):
        from .air import tape as tp_mod

        return tp_mod.domain_plain(tp, main, pp, inter, is_first, f.qm31_words(claimed), ew, pows,
                                   log_trace, stride, acc)
    dev = is_first.device
    out = acc if acc is not None else torch.empty((m, 4), dtype=f.I32, device=dev)
    a = _air_args(tp, main, pp, ew, m, dev)
    a.inter[: len(inter)] = _ptrs(inter, dev)
    a.is_first = _ptrs([is_first], dev)[0]
    a.xs = circle.domain_table(log, dev)[0].data_ptr()
    a.out, a.stride, a.log_trace, a.accumulate = out.data_ptr(), stride, log_trace, int(acc is not None)
    a.claimed[:] = list(f.qm31_words(claimed))
    a.pows[: 4 * len(pows)] = [w for q in pows for w in q]
    AIR_DOMAIN.launch("lum_air_domain", dev, ctypes.addressof(a))
    return out


# ---------------------------------------------------------------------------
# K7: OODS values.


def oods_eval(cols: Sequence[torch.Tensor], chain: Sequence[tuple]) -> torch.Tensor:
    """(C, 4) int32: C M31 coefficient columns of length N = 2^L at the QM31
    point whose twiddle chain (L QM31 words, `fft.twiddle_chain`) is given."""
    cols = list(cols)
    _require(len(cols) > 0, "oods_eval: no columns")
    n = cols[0].shape[0]
    log = _log2(n)
    _require(len(chain) == log and log <= OODS_MAX_LOG, f"oods_eval: chain of {log} points expected")
    _check_rows(cols, n, "oods_eval")
    if _on_cpu(cols[0]):
        return oods_eval_plain(cols, chain)
    dev = cols[0].device
    out = torch.empty((len(cols), 4), dtype=f.I32, device=dev)
    n_chunks = 1 << (log - min(log, OODS_CHUNK_LOG))
    for s in range(0, len(cols), OODS_MAX_COLS):
        batch = cols[s : s + OODS_MAX_COLS]
        a = OodsArgs()
        a.cols[: len(batch)] = _ptrs(batch, dev)
        a.chain[: 4 * log] = [w for q in chain for w in f.qm31_words(q)]
        a.n_cols, a.log_n = len(batch), log
        partial = torch.empty(len(batch) * n_chunks * 4, dtype=f.I32, device=dev)
        OODS_EVAL.launch("lum_oods_eval", dev, ctypes.addressof(a), partial.data_ptr(), out[s].data_ptr())
    return out


def oods_eval_plain(cols: Sequence[torch.Tensor], chain: Sequence[tuple]) -> torch.Tensor:
    """The basis by doubling (entry j: the product of chain[L-1-i] over the
    set bits i of j), then an exact modular dot product."""
    dev = cols[0].device
    basis = f.qm31_one((1,), dev)
    for q in reversed(chain):
        basis = torch.cat([basis, f.qm31_mul(torch.tensor(q, dtype=f.I64, device=dev), basis)])
    c64 = torch.stack(list(cols)).to(f.I64)
    rows = max(1, (1 << 24) // (4 * c64.shape[1]))  # bounds the (rows, N, 4) int64 product
    out = []
    for s in range(0, c64.shape[0], rows):
        prod = (c64[s : s + rows, :, None] * basis[None]) % f.P
        out.append(prod.sum(dim=1) % f.P)
    return torch.cat(out).to(f.I32)
