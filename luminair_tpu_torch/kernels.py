"""The port's hand-written Hopper kernels: build, binding, wrappers.

Four CUDA C++ sources under csrc/ (sharing csrc/m31.cuh) are compiled at
first use with nvcc for sm_90a, one shared library per source, all sources
compiled at once, into build/kernels/ at the repository root; each library
is named by a hash of its sources, so an edit rebuilds it.  The libraries
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


class Kernel:
    """One CUDA source, its C entry points, and a count of launches."""

    def __init__(self, name: str, source: str, replaces: str, symbols: Dict[str, list]):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.symbols = symbols
        self.launches = 0
        self._fns = None

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in (_CSRC / self.source, _CSRC / "m31.cuh"):
            h.update(p.read_bytes())
        return BUILD_DIR / f"{Path(self.source).stem}-{h.hexdigest()[:16]}.so"

    def _load(self):
        with _LOAD_LOCK:
            if self._fns is None:
                path = self.library_path()
                if not path.exists():
                    build()
                lib = ctypes.CDLL(str(path))
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

KERNELS = (CIRCLE_FFT, MERKLE, FRI_FOLD, DEEP_QUOTIENT)


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
    source, all started together.  Returns {kernel name: ptxas report}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for k in KERNELS:
        out = k.library_path()
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(_CSRC / k.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((k, out, tmp, proc))
    reports, errors = {}, []
    for k, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{k.source}:\n{stderr}{stdout}")
            continue
        os.replace(tmp, out)
        reports[k.name] = stderr + stdout
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


def _qm31_words(x) -> List[int]:
    vals = [int(v) for v in (x.tolist() if isinstance(x, torch.Tensor) else list(x))]
    _require(len(vals) == 4, "expected one QM31 value (4 words)")
    return vals


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
    a = _qm31_words(alpha)
    b = _qm31_words(beta2) if mix is not None else [0, 0, 0, 0]
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
    r = f.add(e, f.qm31_mul(torch.tensor(_qm31_words(alpha), dtype=f.I64, device=dev), o))
    if mix is not None:
        b2 = torch.tensor(_qm31_words(beta2), dtype=f.I64, device=dev)
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
