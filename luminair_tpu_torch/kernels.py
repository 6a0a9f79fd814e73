"""The port's hand-written Hopper kernels: build, binding, wrappers.

The CUDA C++ sources under csrc/ (with the headers csrc/m31.cuh,
air.cuh, air_tapes.cuh and check_tapes.cuh (both generated by
air/tape_cuda.py), blake2s.cuh, channel.cuh, check.cuh, decommit.cuh,
fft.cuh, fri.cuh, lut.cuh, merkle.cuh, oods.cuh, quotient.cuh, tape_row.cuh
and trace.cuh)
are compiled at first use with nvcc for sm_90a, one shared
library per source, all sources compiled at once, into build/kernels/ at
the repository root; each library is named by a hash of its source and
every header it includes, so an edit to either rebuilds it.  The libraries
have a plain C interface bound with ctypes: every entry point launches on
PyTorch's current stream, allocates nothing, and returns
cudaGetLastError(), which the wrapper turns into a KernelError (K10's
also copies its result into the caller's pinned word and synchronises the
stream, whose error it returns).

Every wrapper has a plain PyTorch twin here (`*_plain`).  A wrapper takes
the twin only for tensors that lie on the CPU; for CUDA tensors it launches
its kernel or raises.  Each launch counts in tracing's store (`counts()`,
`Kernel.launches`, `SHARD_LAUNCHES`: views of it since `reset_counts()`),
so a run can show that its path went through the kernel.

Storage: int32 tensors holding the reference's uint32 words; the kernels
read the same buffers as uint32.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from collections.abc import Mapping
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import circle
from . import fields as f
from . import fixed
from . import tracing
from .air.preprocessed import find_index_packed
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
    """One kernel: its CUDA source and C entry points.
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
        self._fns = None

    @property
    def launches(self) -> int:
        """Launches since `reset_counts()`."""
        return tracing.since_reset("launches." + self.name)

    @property
    def hosted(self) -> int:
        """Steps of this kernel's work that another kernel's launch ran,
        since `reset_counts()`."""
        return tracing.since_reset("hosted." + self.name)

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
        """One call of `symbol` on `device`'s current stream (`run`)."""
        self.run(self._load()[symbol], device, *args)

    def run(self, fn, device: torch.device, *args):
        """One call of the C entry point `fn` (from `_load`, for a caller
        that keeps it) on `device`'s current stream, with `device` the
        current device for its duration: the C entry
        point launches on (and sets attributes of) the current device.  The
        device is switched only when it is another than the current one."""
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        # The stream's handle without making a torch.cuda.Stream object, as
        # PyTorch's generated code reads it.
        stream = torch._C._cuda_getCurrentRawStream(index)
        if index == current:
            err = fn(*args, stream)
        else:
            with torch.cuda.device(device):
                err = fn(*args, stream)
        if err != 0:
            raise KernelError(f"{self.name}.{fn.__name__}: CUDA error {err} at launch")
        tracing.launch(self.name)


_LOAD_LOCK = threading.Lock()

FFT_TILE_LOG = 12  # rows of a tile pass (csrc/fft.cu)
FFT_GROUP_LOG = 8  # stages of a group pass, at most
FFT_GROUPS_LOG = 5  # groups per CTA of a group pass


class FftPass(ctypes.Structure):
    """Mirror of lum::FftPass (csrc/fft.cuh), passed to K1 by value."""

    _fields_ = [
        ("src", ctypes.c_uint64),
        ("dst", ctypes.c_uint64),
        ("tw", ctypes.c_uint64),
        ("n_cols", ctypes.c_longlong),
        ("log_n", ctypes.c_int),
        ("log_g", ctypes.c_int),
        ("log_w", ctypes.c_int),
        ("log_groups", ctypes.c_int),
        ("l_lo", ctypes.c_int),
        ("l_hi", ctypes.c_int),
        ("inverse", ctypes.c_int),
        ("log_blowup", ctypes.c_int),
        ("dup", ctypes.c_int),
    ]


CIRCLE_FFT = Kernel(
    "circle_fft",
    "fft.cu",
    "luminair_tpu/parallel/accel.py:718 (_jit_lde; _jit_ifft_t :1180, _jit_fft :1730; fft.ifft :248, fft.fft :305, "
    "fft_dup2 :167)",
    {"lum_fft_pass": [FftPass]},
    abi={"lum_fft_tile_log": FFT_TILE_LOG, "lum_fft_group_log": FFT_GROUP_LOG, "lum_fft_groups_log": FFT_GROUPS_LOG,
         "lum_fft_pass_size": ctypes.sizeof(FftPass)},
)
MERKLE_TILE_LOG = 10  # a K2 CTA owns 2^10 nodes of its pass's first layer (csrc/merkle.cu)


class MerklePass(ctypes.Structure):
    """Mirror of lum::MerklePass (csrc/merkle.cuh): one pass of the header's
    host build, at any tile; the card's tile is MERKLE_TILE_LOG.  `state`
    and `slot` (0 or both set, on the pass that writes the root) carry K8's
    channel step."""

    _fields_ = [("desc", ctypes.c_uint64), ("bottom", ctypes.c_int), ("tile_log", ctypes.c_int),
                ("state", ctypes.c_uint64), ("slot", ctypes.c_uint64)]


MERKLE = Kernel(
    "blake2s_merkle",
    "merkle.cu",
    "luminair_tpu/parallel/accel.py:853 (_jit_merkle_tree; _scan_tree_top :1361, _dev_tree_layers :1464)",
    {"lum_merkle_pass": [ctypes.c_uint64, _I, ctypes.c_uint64, ctypes.c_uint64]},
    abi={"lum_merkle_tile_log": MERKLE_TILE_LOG, "lum_merkle_pass_size": ctypes.sizeof(MerklePass)},
)
FRI_MAX_FOLDS = 4  # folds of one K3 launch (csrc/fri.cuh)


class FriLayer(ctypes.Structure):
    """Mirror of lum::FriLayer (csrc/fri.cuh), passed to K3 by value."""

    _fields_ = [
        ("src", ctypes.c_uint64),
        ("out", ctypes.c_uint64),
        ("alpha", ctypes.c_uint64),
        ("alpha0", ctypes.c_uint64),
        ("tw", ctypes.c_uint64 * FRI_MAX_FOLDS),
        ("mix", ctypes.c_uint64 * FRI_MAX_FOLDS),
        ("mix_tw", ctypes.c_uint64 * FRI_MAX_FOLDS),
        ("n", ctypes.c_longlong),
        ("folds", ctypes.c_int),
        ("t0", ctypes.c_int),
    ]


FRI_LAYER = Kernel(
    "fri_layer",
    "fri.cu",
    "luminair_tpu/parallel/accel.py:1299 (_jit_fold_circle; _jit_fold_line :1314; a committed layer's folds in "
    "_jit_fri_layer :1487, _jit_fri_chain :1566)",
    {"lum_fri_layer": [_P]},
    abi={"lum_fri_layer_size": ctypes.sizeof(FriLayer), "lum_fri_max_folds": FRI_MAX_FOLDS},
)
# K4's descriptor (csrc/quotient.cuh): a head, a record per log and per
# group, then the column addresses and the gammas; a CTA of the card takes
# QUOTIENT_CTA_ROWS rows of one log.
DQ_HEAD = 3
DQ_LOG_WORDS = 8
DQ_GROUP_WORDS = 16
QUOTIENT_CTA_ROWS = 128 * 4  # threads x rows per thread (csrc/quotient.cu)
DEEP_QUOTIENT = Kernel(
    "deep_quotient",
    "quotient.cu",
    "luminair_tpu/parallel/accel.py:1248 (_jit_quotient_group, called per group from pcs/quotients.py:144)",
    {"lum_deep_quotient": [_P, _LL, _P]},
    abi={"lum_dq_log_words": DQ_LOG_WORDS, "lum_dq_group_words": DQ_GROUP_WORDS,
         "lum_dq_cta_rows": QUOTIENT_CTA_ROWS},
)

# The tapes' ABI: lookup-element kinds in the order of the elements table
# (csrc/tape_row.cuh), and the limits air/tape.py checks when it records a
# component (the check's word holds K + E <= TAPE_MAX_POWS bits).
ELEM_KINDS = ("node", "sin", "exp2", "log2", "range_check")
TAPE_MAX_REGS = 16
TAPE_MAX_MAIN = 32
TAPE_MAX_PP = 4
TAPE_MAX_RELATIONS = 8
TAPE_MAX_POWS = 32


# K7's descriptor (csrc/oods.cuh): a head, a record per group, then the
# column addresses; one unit of work per (column, chunk of 2^c rows).
OODS_CHUNK_LOG = 11  # c = min(L, 11) on the card
OODS_LANE_GROUPS = 16  # per CTA; a lane group takes one unit at a time
OODS_MAX_LOG = 32
OODS_HEAD = 3
OODS_GROUP_WORDS = 6 + 4 * OODS_MAX_LOG


# The check's launch (csrc/check.cuh): each component's compiled tape
# (csrc/check_tapes.cuh), its columns in one pointer table, its rows in
# CTAs of CHECK_THREADS.
CHECK_MAX_COMPS = 32
CHECK_MAX_COLS = 512
CHECK_THREADS = 256
CHECK_TAPES_HEADER = "check_tapes.cuh"
_CHECK_TAPE_LINE = re.compile(r"^// tape (\d+) (\w+) ([0-9a-f]{64})$", re.M)


class CheckComp(ctypes.Structure):
    """Mirror of lum::CheckComp (csrc/check.cuh)."""

    _fields_ = [
        ("n", ctypes.c_longlong),
        ("out", ctypes.c_longlong),
        ("kind", ctypes.c_int),
        ("col0", ctypes.c_int),
        ("cta0", ctypes.c_int),
        ("pad", ctypes.c_int),
        ("claimed", ctypes.c_uint32 * 4),
    ]


class CheckArgs(ctypes.Structure):
    """Mirror of lum::CheckArgs (csrc/check.cuh), passed by value: 5,808
    bytes of kernel parameters (above 4 KB: CUDA 12.1 or later)."""

    _fields_ = [
        ("cols", ctypes.c_uint64 * CHECK_MAX_COLS),
        ("comps", CheckComp * CHECK_MAX_COMPS),
        ("out", ctypes.c_uint64),
        ("n_comps", ctypes.c_int),
        ("n_ctas", ctypes.c_int),
        ("elems", ctypes.c_uint32 * (len(ELEM_KINDS) * 2 * 4)),
    ]


def tape_digest(tp) -> str:
    """sha256 of a tape: its component's name, its shape (main and
    preprocessed columns, registers, constraints, relation entries: the
    generated code hard-codes the column layout they give) and its int32
    words (little-endian).  How the compiled check tapes name the tape
    each was generated from."""
    return _digest_of((tp.name, tp.n_main, tp.n_pp, tp.n_regs, tp.n_constraints, tp.n_relations), tuple(tp.words))


@functools.lru_cache(maxsize=64)
def _digest_of(shape: tuple, words: tuple) -> str:
    h = hashlib.sha256(repr(shape).encode())
    h.update(np.asarray(words, dtype="<i4").tobytes())
    return h.hexdigest()


@functools.lru_cache(maxsize=None)
def compiled_check_tapes(header: Optional[Path] = None) -> Dict[str, tuple]:
    """{component: (kind, tape digest)} of the tapes compiled into the
    check (the manifest of csrc/check_tapes.cuh)."""
    path = header or _CSRC / CHECK_TAPES_HEADER
    if not path.exists():  # before its first generation
        return {}
    text = path.read_text()
    return {name: (int(kind), digest) for kind, name, digest in _CHECK_TAPE_LINE.findall(text)}


# K5 and K6 (csrc/air.cuh): each component's witness and domain tapes
# compiled (csrc/air_tapes.cuh), every component of a phase in one launch,
# the launch's table a kernel parameter.
AIR_MAX_COMPS = 32
AIR_MAX_COLS = 512
AIR_MAX_POWS = 256
WITNESS_THREADS = 256  # threads of a K5 CTA
WITNESS_MAX_ITEMS = 4  # rows a thread of a K5 tile, at most
# Rows a thread by a launch's rows: (from rows, items), the largest first.
# On an H100 (tools/kernel_timing.py --kernels K5) bench_n256's 2^18 rows
# took 0.0271 / 0.0233 / 0.0254 / 0.0247 ms at 1 / 2 / 3 / 4 rows a
# thread, the PINN's 6.5M rows 0.539 / 0.410 / 0.380 / 0.371 ms.
WITNESS_ITEMS_AT = ((1 << 20, 4), (1 << 17, 2))
DOMAIN_THREADS = 256  # rows of a K6 CTA
AIR_TAPES_HEADER = "air_tapes.cuh"
_AIR_TAPE_LINE = re.compile(r"^// (witness|domain) (\d+) (\w+) ([0-9a-f]{64})$", re.M)


class WitnessComp(ctypes.Structure):
    """Mirror of lum::WitnessComp (csrc/air.cuh)."""

    _fields_ = [("n", ctypes.c_longlong), ("out", ctypes.c_uint64), ("last", ctypes.c_uint64),
                ("carry", ctypes.c_uint64), ("kind", ctypes.c_int), ("col0", ctypes.c_int), ("tile0", ctypes.c_int),
                ("pad", ctypes.c_int)]


class WitnessArgs(ctypes.Structure):
    """Mirror of lum::WitnessArgs (csrc/air.cuh), passed to K5 by value."""

    _fields_ = [
        ("cols", ctypes.c_uint64 * AIR_MAX_COLS),
        ("comps", WitnessComp * AIR_MAX_COMPS),
        ("claimed", ctypes.c_uint64),
        ("flags", ctypes.c_uint64),
        ("sums", ctypes.c_uint64),
        ("counter", ctypes.c_uint64),
        ("base", ctypes.c_uint64),
        ("epoch", ctypes.c_uint64),
        ("n_comps", ctypes.c_int),
        ("n_tiles", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("items", ctypes.c_int),
        ("elems", ctypes.c_uint32 * (len(ELEM_KINDS) * 2 * 4)),
    ]


class DomainComp(ctypes.Structure):
    """Mirror of lum::DomainComp (csrc/air.cuh)."""

    _fields_ = [("kind", ctypes.c_int), ("col0", ctypes.c_int), ("pow0", ctypes.c_int), ("pad", ctypes.c_int),
                ("claimed", ctypes.c_uint32 * 4)]


class DomainSpan(ctypes.Structure):
    """Mirror of lum::DomainSpan (csrc/air.cuh)."""

    _fields_ = [("n", ctypes.c_longlong), ("xs", ctypes.c_uint64), ("out", ctypes.c_uint64),
                ("stride", ctypes.c_int), ("log_trace", ctypes.c_int), ("comp0", ctypes.c_int),
                ("n_comps", ctypes.c_int), ("cta0", ctypes.c_int)]


class DomainArgs(ctypes.Structure):
    """Mirror of lum::DomainArgs (csrc/air.cuh), passed to K6 by value."""

    _fields_ = [
        ("cols", ctypes.c_uint64 * AIR_MAX_COLS),
        ("comps", DomainComp * AIR_MAX_COMPS),
        ("spans", DomainSpan * AIR_MAX_COMPS),
        ("pows", ctypes.c_uint32 * (4 * AIR_MAX_POWS)),
        ("elems", ctypes.c_uint32 * (len(ELEM_KINDS) * 2 * 4)),
        ("n_spans", ctypes.c_int),
        ("n_ctas", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def compiled_air_tapes(header: Optional[Path] = None) -> Dict[tuple, tuple]:
    """{(family, component): (kind, tape digest)} of the witness and domain
    tapes compiled into K5 and K6 (the manifest of csrc/air_tapes.cuh)."""
    path = header or _CSRC / AIR_TAPES_HEADER
    if not path.exists():  # before its first generation
        return {}
    return {(family, name): (int(kind), digest) for family, kind, name, digest in _AIR_TAPE_LINE.findall(
        path.read_text())}


_AIR_ABI = {"lum_air_kinds": len(compiled_air_tapes()) // 2}


# K5's carry pass: every (4, R) block of one shard in one launch.
CARRY_MAX_BLOCKS = 32
CARRY_THREADS = 256


class CarryBlock(ctypes.Structure):
    """Mirror of CarryBlock (csrc/air.cu)."""

    _fields_ = [("rows", ctypes.c_uint64), ("len", ctypes.c_longlong), ("row_ctas", ctypes.c_int),
                ("vec", ctypes.c_int), ("cta0", ctypes.c_int), ("pad", ctypes.c_int)]


class CarryArgs(ctypes.Structure):
    """Mirror of CarryArgs (csrc/air.cu), passed by value."""

    _fields_ = [("blocks", CarryBlock * CARRY_MAX_BLOCKS), ("carry", ctypes.c_uint64),
                ("n_blocks", ctypes.c_int), ("n_ctas", ctypes.c_int)]

AIR_WITNESS = Kernel(
    "air_witness",
    "air.cu",
    "luminair_tpu/parallel/accel.py:1068 (_jit_witness; WitnessEval.build_interaction)",
    {"lum_air_witness": [_P]},
    abi={**_AIR_ABI, "lum_witness_args_size": ctypes.sizeof(WitnessArgs), "lum_witness_threads": WITNESS_THREADS,
         "lum_witness_max_items": WITNESS_MAX_ITEMS},
)
# K5's carry pass on row shards: the cumulative sum across the shards that
# jax.jit derives from _shard_dim's row sharding of build_interaction.
ADD_CARRY = Kernel(
    "add_carry",
    "air.cu",
    "luminair_tpu/parallel/accel.py:1079-1084 (_jit_witness under _shard_dim; build_interaction's cumsum)",
    {"lum_m31_add_carry": [_P]},
    abi={"lum_carry_args_size": ctypes.sizeof(CarryArgs), "lum_carry_threads": CARRY_THREADS},
)
AIR_DOMAIN = Kernel(
    "air_domain",
    "air.cu",
    "luminair_tpu/parallel/accel.py:1112 (_jit_domain; DomainEval)",
    {"lum_air_domain": [_P]},
    abi={**_AIR_ABI, "lum_domain_args_size": ctypes.sizeof(DomainArgs), "lum_domain_threads": DOMAIN_THREADS},
)
AIR_CHECK = Kernel(
    "air_check",
    "air.cu",
    "luminair_tpu/air/debug.py:20 (_CheckEval, host numpy)",
    {"lum_air_check": [_P]},
    abi={"lum_check_args_size": ctypes.sizeof(CheckArgs), "lum_check_threads": CHECK_THREADS,
         "lum_check_kinds": len(compiled_check_tapes())},
)
OODS_EVAL = Kernel(
    "oods_eval",
    "oods.cu",
    "luminair_tpu/parallel/accel.py:1792 (_jit_eval_at_point; fft.eval_at_point_many :492)",
    {"lum_oods_eval": [_P, _I, _LL, _LL, _P, _P]},
    abi={"lum_oods_lane_groups": OODS_LANE_GROUPS, "lum_oods_group_words": OODS_GROUP_WORDS},
)

# The channel state on the card (csrc/channel.cuh): {digest[8], counter,
# alpha[4]} int32 words.  K8's launches draw alpha0; each FRI layer's step
# runs in K2's root pass and counts in CHANNEL.hosted.
CHANNEL_WORDS = 13
CHANNEL = Kernel(
    "fri_channel",
    "channel.cu",
    "luminair_tpu/parallel/accel.py:1409 (_dev_draw_block; _dev_draw_felt :1421, _dev_mix_root :1449, "
    "_jit_draw_felt :1458; the chain _jit_fri_layer :1487, _jit_fri_chain :1566)",
    {"lum_channel_draw_felt": [_P, _P]},
    abi={"lum_channel_words": CHANNEL_WORDS},
)
# The decommit pass's ABI (csrc/decommit.cuh): a tree descriptor and a
# tree's record in a pass, int64 words.
DC_MAX_LOG = 31
DC_DESC_WORDS = 1 + 5 * (DC_MAX_LOG + 1)
DC_TREE_WORDS = 4 + 2 * (DC_MAX_LOG + 1)
DC_SHARED_BYTES = 200 * 1024  # the most shared memory a CTA's position lists take
DECOMMIT = Kernel(
    "decommit",
    "decommit.cu",
    "luminair_tpu/parallel/accel.py:925 (_jit_gather_cols; _jit_gather_many :968, gather_many :993; "
    "crypto/merkle.py computed_positions :41, decommit :169, queried_values :209)",
    {"lum_decommit": [_P, _I, _I, _I, _P, _P]},
    abi={"lum_dc_tree_words": DC_TREE_WORDS, "lum_dc_desc_words": DC_DESC_WORDS,
         "lum_dc_shared_bytes": DC_SHARED_BYTES},
)
POW_THREADS = 128  # K10's CTA (csrc/channel.cu)
POW_CTAS_PER_SM = 2
POW_ROUND_WORK = 8  # a round of a search below the card's width: 8 times its expected candidates


class PowArgs(ctypes.Structure):
    """Mirror of lum::PowArgs (csrc/channel.cuh), K10's launch parameters."""

    _fields_ = [("digest", ctypes.c_uint32 * 8), ("limit", ctypes.c_uint64), ("scratch", ctypes.c_uint64),
                ("bits", ctypes.c_int), ("parity", ctypes.c_int)]


GRIND_POW = Kernel(
    "grind_pow",
    "channel.cu",
    "luminair_tpu/crypto/channel.py:104 (grind_pow, batched numpy Blake2s on the host; not a device program)",
    {"lum_grind_pow": [_P, _I, _P]},
    abi={"lum_channel_words": CHANNEL_WORDS, "lum_pow_args_size": ctypes.sizeof(PowArgs),
         "lum_pow_threads": POW_THREADS, "lum_pow_ctas_per_sm": POW_CTAS_PER_SM},
)

# The trace kernels' ABI (csrc/trace.cuh): ops and column slots in enum
# order, the views' rank limit, a segment's tile.
TRACE_OPS = (
    "add", "mul", "rem", "less_than", "inputs", "recip", "square", "sqrt", "lut", "contiguous",
    "sum_reduce", "max_reduce", "pad", "encode",
)
TRACE_COLS = (
    "node_id", "idx", "is_last_idx", "next_node_id", "next_idx", "lhs_id", "next_lhs_id", "rhs_id",
    "next_rhs_id", "input_id", "next_input_id", "lhs", "rhs", "input", "out", "rem", "quotient", "borrow",
    "diff", "limb0", "limb1", "limb2", "limb3", "scale", "lookup_mult", "lhs_mult", "rhs_mult", "input_mult",
    "out_mult", "range_check_mult", "val", "multiplicity", "acc", "next_acc", "max_val", "next_max_val",
    "is_max", "is_last_step", "ge_limb0", "ge_limb1", "ge_limb2", "ge_limb3",
)
VIEW_MAX_DIMS = 8
SEG_TILE = 256  # rows of a tile of the segment interpreter
SEG_CHAIN = 8  # descriptors a CTA of the segment interpreter holds at once
# A chain of more rows takes tiles of more rows a thread (tools/kernel_timing.py --kernels trace_segment).
SEG_MAX_TILES = 256


def fast_divmod(size: int) -> tuple:
    """(magic, shift) with n // size == (n * magic) >> shift for every
    0 <= n < 2^31: shift = 31 + ceil(log2 size), magic = ceil(2^shift /
    size), below 2^32 (csrc/trace.cuh, fast_div)."""
    shift = 31 + (size - 1).bit_length()
    return -(-(1 << shift) // size), shift


def _chain_tiles(rows: int) -> tuple:
    """(tiles, shift) of a chain of `rows` kernel rows: tiles of SEG_TILE <<
    shift rows, the least shift that keeps them to SEG_MAX_TILES."""
    tiles = -(-rows // SEG_TILE)
    shift = max(0, (tiles - 1).bit_length() - SEG_MAX_TILES.bit_length() + 1)
    return -(-rows // (SEG_TILE << shift)), shift


class ViewDesc(ctypes.Structure):
    """Mirror of lum::ViewDesc (csrc/trace.cuh): graph/view.py View.packed()."""

    _fields_ = [
        ("strides", ctypes.c_longlong * VIEW_MAX_DIMS),
        ("base", ctypes.c_longlong),
        ("len", ctypes.c_longlong),
        ("sizes", ctypes.c_uint32 * VIEW_MAX_DIMS),
        ("magic", ctypes.c_uint32 * VIEW_MAX_DIMS),
        ("shift", ctypes.c_uint32 * VIEW_MAX_DIMS),
        ("lo", ctypes.c_int32 * VIEW_MAX_DIMS),
        ("hi", ctypes.c_int32 * VIEW_MAX_DIMS),
        ("ndim", ctypes.c_int),
        ("fresh", ctypes.c_int),
    ]


class TraceArgs(ctypes.Structure):
    """Mirror of lum::TraceArgs (csrc/trace.cuh): one row range of a launch,
    a row of a pass's node table (trace_segment) or T3's argument."""

    _fields_ = [
        ("src", ctypes.c_uint64 * 2),
        ("view", ViewDesc * 2),
        ("out", ctypes.c_uint64),
        ("cols", ctypes.c_uint64 * len(TRACE_COLS)),
        ("lut_lo", ctypes.c_uint64),
        ("lut_hi", ctypes.c_uint64),
        ("lut_start", ctypes.c_uint64),
        ("lut_out", ctypes.c_uint64),
        ("mult", ctypes.c_uint64),
        ("flag", ctypes.c_uint64),
        ("n", ctypes.c_longlong),
        ("n_in", ctypes.c_longlong),
        ("n_out", ctypes.c_longlong),
        ("dsize", ctypes.c_longlong),
        ("back", ctypes.c_longlong),
        ("lut_n", ctypes.c_longlong),
        ("op", ctypes.c_int),
        ("n_ranges", ctypes.c_int),
        ("node_id", ctypes.c_uint32),
        ("id0", ctypes.c_uint32),
        ("id1", ctypes.c_uint32),
        ("out_mult", ctypes.c_uint32),
        ("in_mult", ctypes.c_uint32),
        ("pad_", ctypes.c_uint32),
    ]


class SegChain(ctypes.Structure):
    """Mirror of lum::SegChain (csrc/trace.cuh)."""

    _fields_ = [("first", ctypes.c_int), ("count", ctypes.c_int), ("tile0", ctypes.c_longlong),
                ("shift", ctypes.c_int), ("pad_", ctypes.c_int)]


class SegPhase(ctypes.Structure):
    """Mirror of lum::SegPhase (csrc/trace.cuh)."""

    _fields_ = [("first", ctypes.c_int), ("count", ctypes.c_int), ("tiles", ctypes.c_longlong)]


class SegArgs(ctypes.Structure):
    """Mirror of lum::SegArgs (csrc/trace.cuh), passed to trace_segment."""

    _fields_ = [
        ("nodes", ctypes.c_uint64),
        ("chains", ctypes.c_uint64),
        ("phases", ctypes.c_uint64),
        ("barrier", ctypes.c_uint64),
        ("max_tiles", ctypes.c_longlong),
        ("p0", ctypes.c_int),
        ("p1", ctypes.c_int),
    ]


def _trace_layout() -> int:
    """lum::trace_layout() from the mirrors: the fields' offsets, folded."""
    fields = [
        (ViewDesc, "strides"), (ViewDesc, "base"), (ViewDesc, "len"), (ViewDesc, "sizes"), (ViewDesc, "magic"),
        (ViewDesc, "shift"), (ViewDesc, "lo"), (ViewDesc, "hi"), (ViewDesc, "ndim"), (ViewDesc, "fresh"),
        (TraceArgs, "src"),
        (TraceArgs, "view"), (TraceArgs, "out"), (TraceArgs, "cols"), (TraceArgs, "lut_lo"), (TraceArgs, "mult"),
        (TraceArgs, "flag"), (TraceArgs, "n"), (TraceArgs, "n_in"), (TraceArgs, "dsize"), (TraceArgs, "lut_n"),
        (TraceArgs, "op"), (TraceArgs, "n_ranges"), (TraceArgs, "node_id"), (TraceArgs, "out_mult"),
        (TraceArgs, "in_mult"), (SegChain, "tile0"), (SegChain, "shift"), (SegPhase, "tiles"), (SegArgs, "chains"), (SegArgs, "max_tiles"),
        (SegArgs, "p0"),
    ]
    h = 0
    for struct, name in fields:
        h = (h * 1000003 + getattr(struct, name).offset) & ((1 << 61) - 1)
    return h


_TRACE_ABI = {
    "lum_trace_args_size": ctypes.sizeof(TraceArgs),
    "lum_seg_args_size": ctypes.sizeof(SegArgs),
    "lum_seg_phase_size": ctypes.sizeof(SegPhase),
    "lum_seg_chain_size": ctypes.sizeof(SegChain),
    "lum_trace_layout": _trace_layout(),
    "lum_trace_n_cols": len(TRACE_COLS),
    "lum_trace_n_ops": len(TRACE_OPS),
    "lum_view_max_dims": VIEW_MAX_DIMS,
    "lum_seg_tile": SEG_TILE,
    "lum_seg_chain": SEG_CHAIN,
}
_TRACE_REPLACES = "luminair_tpu/graph/device_trace.py:158 (_Tracer._traced; settings segments _segment_fn :559)"

TRACE_SEGMENT = Kernel("trace_segment", "trace.cu", _TRACE_REPLACES, {"lum_trace_segment": [_P]}, abi=_TRACE_ABI)
TRACE_REDUCE = Kernel("trace_reduce", "trace.cu", _TRACE_REPLACES, {"lum_trace_reduce": [_P]}, abi=_TRACE_ABI)
LUT_THREADS = 256  # T4's CTA (csrc/lut.cuh)
LUT_PAIRS = 4  # 16-byte pairs of the source a thread before a second CTA is taken
LUT_MAX_CTAS = 256
LUT_BOUNDARY = Kernel(
    "lut_boundary", "trace.cu",
    "luminair_tpu/graph/device_trace.py:552 (the LUT boundary (inp, jnp.min, jnp.max) of _segment_fn, :556)",
    {"lum_lut_boundary": [_P, _LL, _P, _LL, _P, _LL]},
    abi={**_TRACE_ABI, "lum_lut_threads": LUT_THREADS, "lum_lut_pairs": LUT_PAIRS, "lum_lut_max_ctas": LUT_MAX_CTAS},
)

LOGUP_MAX_K = 32  # relation columns of one logup_sum call (csrc/logup.cu)
LOGUP_THREADS = 256


class LogupArgs(ctypes.Structure):
    """Mirror of LogupArgs (csrc/logup.cu), logup_sum's launch parameters."""

    _fields_ = [
        ("values", ctypes.c_uint64),
        ("mult", ctypes.c_uint64),
        ("partial", ctypes.c_uint64),
        ("out", ctypes.c_uint64),
        ("n", ctypes.c_longlong),
        ("stride", ctypes.c_longlong),
        ("k", ctypes.c_int),
        ("pad_", ctypes.c_int),
        ("z", ctypes.c_uint32 * 4),
        ("pows", ctypes.c_uint32 * (4 * LOGUP_MAX_K)),
    ]


LOGUP_SUM = Kernel(
    "logup_sum",
    "logup.cu",
    "luminair_tpu/parallel/sharding.py:184 (_logup_sum_body; _compiled_prover_step :224)",
    {"lum_logup_sum": [_P, _I]},
    abi={"lum_logup_args_size": ctypes.sizeof(LogupArgs), "lum_logup_max_k": LOGUP_MAX_K,
         "lum_logup_threads": LOGUP_THREADS},
)

KERNELS = (
    CIRCLE_FFT, MERKLE, FRI_LAYER, DEEP_QUOTIENT, AIR_WITNESS, AIR_DOMAIN, OODS_EVAL, CHANNEL, DECOMMIT, GRIND_POW,
    TRACE_SEGMENT, TRACE_REDUCE, LUT_BOUNDARY, AIR_CHECK, LOGUP_SUM, ADD_CARRY,
)


reset_counts = tracing.reset_counts


def counts() -> Dict[str, int]:
    """Launches by kernel since `reset_counts()`."""
    return {k.name: k.launches for k in KERNELS}


class _ShardLaunches(Mapping):
    """Launches by the shard of a mesh that made them (parallel/sharding.py)
    since `reset_counts()`: {mesh position, or "lead" for the top of a
    sharded tree: {kernel: n}}, for every shard entered since."""

    def __getitem__(self, shard):
        return tracing.shard_launches()[shard]

    def __iter__(self):
        return iter(tracing.shard_launches())

    def __len__(self):
        return len(tracing.shard_launches())


SHARD_LAUNCHES = _ShardLaunches()
# While active, the launches made count also under the shard.
on_shard = tracing.on_shard


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


def fft_passes(log_n: int, log_lo: int, inverse: bool, tile_log: int = FFT_TILE_LOG,
               group_log: int = FFT_GROUP_LOG) -> List[tuple]:
    """The launches of one transform of 2^log_n rows that runs the stages
    with blocks 2^log_lo .. 2^log_n (the inverse: all of them, largest
    first), in order: (log_g, log_w, l_lo, l_hi) each, its stages' blocks
    2^(log_w + l) for l in l_lo..l_hi.  A tile pass (log_w = 0) runs every
    stage whose block fits in a tile of min(2^tile_log, 2^log_n) rows; the
    larger blocks go into group passes of at most `group_log` stages, split
    evenly."""
    if log_lo > log_n:
        return []
    t = min(tile_log, log_n)
    passes = [(t, 0, log_lo, t)] if log_lo <= t else []
    a = max(log_lo, t + 1)
    n_outer = log_n - a + 1
    if n_outer > 0:
        k = -(-n_outer // group_log)
        for i in range(k):
            r = n_outer // k + (1 if i < n_outer % k else 0)
            passes.append((r, a - 1, 1, r))
            a += r
    return passes[::-1] if inverse else passes


def _fft_launch(src: torch.Tensor, out_shape, log_lo: int, inverse: bool, log_blowup: int = 0,
                dup: bool = False, tile_log: int = FFT_TILE_LOG, group_log: int = FFT_GROUP_LOG,
                run=None) -> torch.Tensor:
    """Every pass of one transform of `out_shape` (n_cols, 2^log_n), each
    one launch (or `run(FftPass)`): the first reads `src` (the coefficients
    of an LDE when log_blowup > 0); a later tile pass runs in place, a
    group pass into the other buffer."""
    n_cols, n = out_shape
    log_n = _log2(n)
    dev = src.device
    tw = circle.twiddle_table(log_n, inverse, dev)
    bufs = [torch.empty(out_shape, dtype=f.I32, device=dev)]
    cur = src
    for i, (log_g, log_w, l_lo, l_hi) in enumerate(fft_passes(log_n, log_lo, inverse, tile_log, group_log)):
        if i == 0:
            dst = bufs[0]
        elif log_w == 0:
            dst = cur
        else:
            if len(bufs) == 1:
                bufs.append(torch.empty(out_shape, dtype=f.I32, device=dev))
            dst = bufs[1] if cur is bufs[0] else bufs[0]
        p = FftPass(cur.data_ptr(), dst.data_ptr(), tw.data_ptr(), n_cols, log_n, log_g, log_w,
                    min(FFT_GROUPS_LOG, log_w), l_lo, l_hi, int(inverse), log_blowup if i == 0 else 0,
                    int(dup and i == 0))
        if run is None:
            CIRCLE_FFT.launch("lum_fft_pass", dev, p)
        else:
            run(p)
        cur = dst
    return cur


def circle_ifft(values: torch.Tensor) -> torch.Tensor:
    """Interpolate (C, N) domain values into (C, N) circle coefficients."""
    _check_cols(values, "circle_ifft")
    if _on_cpu(values):
        return circle_ifft_plain(values)
    if _log2(values.shape[1]) == 0:
        return values.clone()
    return _fft_launch(values.contiguous(), tuple(values.shape), 1, True)


def circle_fft(coeffs: torch.Tensor, m_start: int = 2) -> torch.Tensor:
    """Evaluate (C, N) coefficients on the domain; stages with block size
    below m_start are skipped (the input already holds their output)."""
    _check_cols(coeffs, "circle_fft")
    if _on_cpu(coeffs):
        return circle_fft_plain(coeffs, m_start)
    log_lo = _log2(m_start)
    if log_lo > _log2(coeffs.shape[1]):
        return coeffs.clone()
    return _fft_launch(coeffs.contiguous(), tuple(coeffs.shape), log_lo, False)


def circle_lde(coeffs: torch.Tensor, log_blowup: int) -> torch.Tensor:
    """Evaluate (C, n) coefficients on the 2^log_blowup times larger domain."""
    _check_cols(coeffs, "circle_lde")
    if _on_cpu(coeffs):
        return circle_lde_plain(coeffs, log_blowup)
    _require(log_blowup >= 1, "circle_lde: log_blowup >= 1")
    n_cols, n = coeffs.shape
    duplicate = log_blowup == 1 and n > 1
    return _fft_launch(coeffs.contiguous(), (n_cols, n << log_blowup), 2 if duplicate else 1, False, log_blowup,
                       duplicate)


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
# K2: a whole Blake2s Merkle tree.


def tree_layers(bottom: int, device) -> Dict[int, torch.Tensor]:
    """The digest layers {log: (2^log, 8) int32} of a tree of 2^bottom
    leaves, log 0 .. bottom: contiguous views of one allocation."""
    buf = torch.empty(((2 << bottom) - 1, 8), dtype=f.I32, device=device)
    return {log: buf[(1 << log) - 1 : (2 << log) - 1] for log in range(bottom + 1)}


def merkle_passes(bottom: int, tile_log: int = MERKLE_TILE_LOG) -> List[int]:
    """The first layer of each pass of a tree of 2^bottom leaves: a pass
    hashes its first layer and the min(tile_log, first) layers above it."""
    passes, b = [], bottom
    while b >= 0:
        passes.append(b)
        b -= min(b, tile_log) + 1
    return passes


def _merkle_launch(desc: "TreeDesc", tile_log: int = MERKLE_TILE_LOG, run=None, state=None, slot=None,
                   start: Optional[int] = None) -> None:
    """Every pass of one tree from layer `start` (the bottom by default)
    up: one launch each on the card, whose tile is 2^MERKLE_TILE_LOG, or
    `run(MerklePass)` at any tile (the host build).  With a channel
    (`state`, `slot`) the last pass, which writes the root, also runs K8's
    step."""
    _require(tile_log >= 0 and (run is not None or tile_log == MERKLE_TILE_LOG),
             f"merkle_tree: the card's tile log is {MERKLE_TILE_LOG}")
    passes = merkle_passes(desc.bottom if start is None else start, tile_log)
    for b in passes:
        ch = (state.data_ptr(), slot.data_ptr()) if state is not None and b == passes[-1] else (0, 0)
        if run is None:
            MERKLE.launch("lum_merkle_pass", desc.words.device, desc.words.data_ptr(), b, *ch)
        else:
            run(MerklePass(desc.words.data_ptr(), b, tile_log, *ch))
    if state is not None and run is None:
        tracing.count("hosted." + CHANNEL.name)


def merkle_tree(desc: "TreeDesc", state: Optional[torch.Tensor] = None, slot: Optional[torch.Tensor] = None,
                start: Optional[int] = None) -> None:
    """Hash every layer of the tree that `desc` describes into its digest
    layers, from the columns up: node i of layer log is H(layer[log+1][2i]
    || layer[log+1][2i+1] || cols[log][:, i]) (no children on the bottom
    layer).  From layer `start` < bottom when given: the layers below it
    already hold their digests (the top of a row-sharded tree, whose layer
    start + 1 holds the shards' roots).  On the card: one launch per pass
    (`merkle_passes`).  With a channel `state` (CHANNEL_WORDS words) and a
    record `slot` (12 words): then K8's step, the root mixed into the state
    and one QM31 drawn, the slot receiving the root and the alpha -- on the
    card inside the root pass, which needs no launch of its own."""
    _require((state is None) == (slot is None), "merkle_tree: a channel state and a record slot, or neither")
    _require(start is None or 0 <= start < desc.bottom, f"merkle_tree: start layer {start} of a tree of bottom "
             f"{desc.bottom}")
    dev = desc.layers[desc.bottom].device
    if state is not None:
        _check_words(state, CHANNEL_WORDS, "channel state", dev)
        _check_words(slot, 12, "merkle_tree slot", dev)
    if _on_cpu(desc.layers[desc.bottom]):
        merkle_tree_plain(desc, start)
        if state is not None:
            channel_mix_root_draw_plain(state, desc.layers[0][0], slot)
        return
    _merkle_launch(desc, state=state, slot=slot, start=start)


def merkle_tree_plain(desc: "TreeDesc", start: Optional[int] = None) -> None:
    start = desc.bottom if start is None else start
    prev = desc.layers[start + 1] if start < desc.bottom else None
    for log in range(start, -1, -1):
        prev = desc.layers[log].copy_(merkle_layer_plain(prev, desc.cols.get(log)))


def merkle_layer_plain(prev: Optional[torch.Tensor], cols: Optional[torch.Tensor]) -> torch.Tensor:
    """Digests (n, 8) of node i = H(prev[2i] || prev[2i+1] || cols[:, i]);
    prev: (2n, 8) child digests or None (the bottom layer); cols: a (k, n)
    view or None."""
    parts = []
    if prev is not None:
        parts.append(prev.reshape(-1, 16))
    if cols is not None:
        parts.append(cols.t())
    return blake2s.hash_words_plain(torch.cat(parts, dim=1))


# ---------------------------------------------------------------------------
# K3: the folds of a committed FRI layer.


def _words(x) -> List[int]:
    try:
        return list(f.qm31_words(x))
    except ValueError as e:
        raise KernelError(str(e)) from None


def _row_major(t: torch.Tensor, rows: int, what: str) -> None:
    """A (rows, 4) int32 QM31 tensor, contiguous; on the card 16-byte aligned
    (K3 moves a row as one 128-bit access)."""
    _require(t.dtype == f.I32 and tuple(t.shape) == (rows, 4) and t.is_contiguous(),
             f"fri_layer: {what} must be contiguous int32 ({rows}, 4)")
    _require(_on_cpu(t) or t.data_ptr() % 16 == 0, f"fri_layer: {what} must be 16-byte aligned")


def _qm31_slot(t: torch.Tensor, beside: torch.Tensor, what: str) -> None:
    _require(t.dtype == f.I32 and tuple(t.shape) == (4,) and t.is_contiguous() and t.device == beside.device,
             f"fri_layer: {what} must be 4 contiguous int32 words beside the values")


def fri_layer(values: torch.Tensor, twiddles: Sequence[torch.Tensor], alpha: torch.Tensor, t0: int = 0,
              mixes: Optional[Sequence] = None, alpha0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: F = len(twiddles) folds of one committed FRI layer in one launch.
    values (2^L, 4) -> (2^(L-F), 4).  Fold t pairs rows (j, N_t - 1 - j) of
    its N_t = 2^(L-t) with twiddles[t] (N_t / 2 words) and beta_t =
    alpha^(2^(t0 + t)), alpha 4 words on the values' device (as K8 draws
    it); mixes[t], when given and not None, is (input, circle twiddles): the
    FRI input of circle log L - t (N_t rows), circle-folded with alpha0 and
    added scaled by beta_t^2 (csrc/fri.cuh)."""
    F = len(twiddles)
    _require(1 <= F <= FRI_MAX_FOLDS, f"fri_layer: 1 to {FRI_MAX_FOLDS} folds a launch, got {F}")
    rows = values.shape[0]
    _require(rows >> F > 0 and rows == (rows >> F) << F, f"fri_layer: {rows} rows do not fold {F} times")
    _row_major(values, rows, "values")
    _qm31_slot(alpha, values, "alpha")
    _require(0 <= t0 <= 8, "fri_layer: first fold index in 0..8")
    mixes = list(mixes) if mixes is not None else [None] * F
    _require(len(mixes) == F, "fri_layer: one mix entry a fold")
    for t, tw in enumerate(twiddles):
        n = rows >> (t + 1)
        _require(tw.dtype == f.I32 and tuple(tw.shape) == (n,) and tw.is_contiguous() and tw.device == values.device,
                 f"fri_layer: twiddles of fold {t} must be contiguous int32 ({n},)")
        if mixes[t] is not None:
            m, mtw = mixes[t]
            _row_major(m, 2 * n, f"the input joining at fold {t}")
            _require(mtw.dtype == f.I32 and tuple(mtw.shape) == (n,) and mtw.is_contiguous()
                     and m.device == mtw.device == values.device,
                     f"fri_layer: circle twiddles of fold {t} must be contiguous int32 ({n},)")
    if any(m is not None for m in mixes):
        _require(alpha0 is not None, "fri_layer: a joining input needs alpha0")
        _qm31_slot(alpha0, values, "alpha0")
    if _on_cpu(values):
        return fri_layer_plain(values, twiddles, alpha, t0, mixes, alpha0)
    return _fri_layer_launch(values, twiddles, alpha, t0, mixes, alpha0,
                             lambda args: FRI_LAYER.launch("lum_fri_layer", values.device, ctypes.addressof(args)))


def _fri_layer_launch(values, twiddles, alpha, t0, mixes, alpha0, run) -> torch.Tensor:
    """The layer's output, written by `run` (the card's launch, or a host
    build of csrc/fri.cuh) from its FriLayer."""
    F = len(twiddles)
    out = torch.empty((values.shape[0] >> F, 4), dtype=f.I32, device=values.device)
    pad = [0] * (FRI_MAX_FOLDS - F)
    run(FriLayer(
        values.data_ptr(), out.data_ptr(), alpha.data_ptr(), alpha0.data_ptr() if alpha0 is not None else 0,
        (ctypes.c_uint64 * FRI_MAX_FOLDS)(*[tw.data_ptr() for tw in twiddles], *pad),
        (ctypes.c_uint64 * FRI_MAX_FOLDS)(*[m[0].data_ptr() if m is not None else 0 for m in mixes], *pad),
        (ctypes.c_uint64 * FRI_MAX_FOLDS)(*[m[1].data_ptr() if m is not None else 0 for m in mixes], *pad),
        out.shape[0], F, t0,
    ))
    return out


def fri_layer_plain(values, twiddles, alpha, t0: int = 0, mixes=None, alpha0=None) -> torch.Tensor:
    """One fri_fold_plain a fold, each joining input's circle fold apart."""
    beta = f.to_u32_i64(alpha)
    for _ in range(t0):
        beta = f.qm31_mul(beta, beta)
    for t, tw in enumerate(twiddles):
        mix = mixes[t] if mixes is not None else None
        beta2 = f.qm31_mul(beta, beta)
        line = fri_fold_plain(mix[0], mix[1], f.to_u32_i64(alpha0)) if mix is not None else None
        values = fri_fold_plain(values, tw, beta, line, beta2 if mix is not None else None)
        beta = beta2
    return values


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
# K4: the DEEP quotients of every (log, point) group of a prove.

# u^-1 = u (2 + i)^-1 = u (2 - i) / 5 in QM31 = CM31[u] / (u^2 - (2 + i)).
_INV5 = pow(5, f.P - 2, f.P)
U_INV = (0, 0, 2 * _INV5 % f.P, (f.P - _INV5) % f.P)


class QuotientPlan:
    """The host's plan of one K4 call: every (commit log, sample point)
    group of a prove, `groups` = [(log, S int32 (2^log,) columns, (S, 4)
    gammas, (5, 4) consts = A, B, C, acc_a, acc_c0)], QM31 as int64 numpy
    arrays or tensors (pcs/quotients.quotient_groups); logs in
    first-appearance order.  A, B and C must come from a sample point: they
    lie in u * CM31.  Holds the descriptor of csrc/quotient.cuh (int64
    words, CTAs of `cta_rows` rows, built on the host) and, on the card,
    its one upload.

    shard = (r, s): the columns are row block r of 2^s, 2^(log - s) rows
    from row r 2^(log - s) of D_log; the descriptor counts those rows and
    points its domain tables at the block's first row (quotient.cuh reads
    the row index for nothing else)."""

    def __init__(self, groups: Sequence[tuple], cta_rows: int = QUOTIENT_CTA_ROWS, shard: tuple = (0, 0)):
        self.groups = [(log, list(cols), np.asarray(g, dtype=np.int64), np.asarray(c, dtype=np.int64))
                       for log, cols, g, c in groups]
        _require(len(self.groups) > 0, "deep_quotient_many: no group")
        self.dev = dev = self.groups[0][1][0].device
        r, s = self.shard = shard
        _require(0 <= r < 1 << s and all(log >= s for log, *_ in self.groups),
                 "deep_quotient_many: a row block of every log")
        rank: Dict[int, int] = {}  # logs in first-appearance order
        for log, cols, gammas, consts in self.groups:
            rank.setdefault(log, len(rank))
            _require(len(cols) > 0 and gammas.shape == (len(cols), 4), "deep_quotient_many: one gamma per column")
            _require(consts.shape == (5, 4), "deep_quotient_many: consts (5, 4)")
        logs = np.array(list(rank))
        n = np.left_shift(1, logs - s)
        r0, ctas = np.cumsum(n) - n, -(-n // cta_rows)
        self.rows = dict(zip(logs.tolist(), r0.tolist()))  # the first output row of each log
        self.n_rows, self.n_ctas = int(n.sum()), int(ctas.sum())
        # Group records in log order: a log's groups are consecutive.
        lid = np.array([rank[g[0]] for g in self.groups])
        order = np.argsort(lid, kind="stable").tolist()
        per_log = np.bincount(lid, minlength=len(logs))
        consts = np.stack([self.groups[i][3] for i in order]) % f.P  # (G, 5, 4)
        _require(not consts[:, :3, :2].any(), "deep_quotient_many: A, B, C of a group do not lie in u * CM31")
        G = len(order)
        recs = np.zeros((G, DQ_GROUP_WORDS), dtype=np.int64)
        d = consts[:, :3, 2:]  # A, B, C over u: dx = A, dy = -B, d0 = C
        recs[:, 2:4], recs[:, 4:6], recs[:, 6:8] = d[:, 0], (f.P - d[:, 1]) % f.P, d[:, 2]
        # Times u^-1, in one product: the gammas, then -acc_a and -acc_c0 of every group.
        folded = np.concatenate([np.concatenate([self.groups[i][2] for i in order]),
                                 (f.P - consts[:, 3:]).reshape(-1, 4) % f.P])
        folded = f.qm31_mul(torch.from_numpy(folded), f.constant(U_INV)).numpy()
        recs[:, 8:16] = folded[len(folded) - 2 * G :].reshape(G, 8)
        recs[:, 0] = [len(self.groups[i][1]) for i in order]
        recs[:, 1] = np.cumsum(recs[:, 0]) - recs[:, 0]
        self._domains = [circle.domain_table(log, dev) for log in rank]  # kept alive: the descriptor points at them
        first = 4 * r * n  # the block's first row in each log's domain tables, in bytes
        table = np.stack([logs - s, np.cumsum(per_log) - per_log, per_log, np.cumsum(ctas) - ctas, ctas, r0,
                          [xs.data_ptr() for xs, _ in self._domains] + first,
                          [ys.data_ptr() for _, ys in self._domains] + first], 1)
        ptrs = []
        for i in order:
            log, cols = self.groups[i][:2]
            _require(all(c.dtype == f.I32 and c.shape == (1 << (log - s),) and c.device == dev and c.is_contiguous()
                         for c in cols),
                     f"deep_quotient_many: columns must be contiguous int32 (2^{log - s},) on one device")
            ptrs += [c.data_ptr() for c in cols]
        gw = folded[: len(ptrs)].astype(np.uint32).reshape(-1).view(np.int64)
        head = np.array([len(logs), G, len(ptrs)], dtype=np.int64)
        self.desc = np.concatenate([head, table.reshape(-1), recs.reshape(-1), np.array(ptrs, dtype=np.int64), gw])
        self.words = f.upload(self.desc, dev) if dev.type == "cuda" else None


def deep_quotient_many(plan: QuotientPlan) -> Dict[int, torch.Tensor]:
    """{log: (2^log, 4) int32}: per log of the plan (first appearance
    first), the sum of its groups' DEEP quotients on D_log (see
    quotient.cu).  On the card: one launch over the plan's uploaded
    descriptor, every log's output written once."""
    if _on_cpu(plan.groups[0][1][0]):
        return deep_quotient_many_plain(plan)
    out = torch.empty((plan.n_rows, 4), dtype=f.I32, device=plan.dev)
    DEEP_QUOTIENT.launch("lum_deep_quotient", plan.dev, plan.words.data_ptr(), plan.n_ctas, out.data_ptr())
    s = plan.shard[1]
    return {log: out[r0 : r0 + (1 << (log - s))] for log, r0 in plan.rows.items()}


def deep_quotient_many_plain(plan: QuotientPlan) -> Dict[int, torch.Tensor]:
    """The same sums, group by group through deep_quotient_plain, whose
    denominator is the general QM31 line A x - B y + C."""
    r, s = plan.shard
    out: Dict[int, torch.Tensor] = {}
    for log, cols, gammas, consts in plan.groups:
        out[log] = deep_quotient_plain(cols, gammas, consts, log, out.get(log), r << (log - s))
    return {log: out[log] for log in plan.rows}


def deep_quotient_plain(cols, gammas, consts, log: int, acc=None, row0: int = 0) -> torch.Tensor:
    """One group's quotients at rows [row0, row0 + len(cols[0])) of D_log."""
    dev = cols[0].device
    rows = cols[0].shape[0]
    xs, ys = (t[row0 : row0 + rows].to(f.I64) for t in circle.domain_table(log, dev))
    g = torch.as_tensor(gammas, dtype=f.I64, device=dev)
    A, B, C, acc_a, acc_c0 = torch.as_tensor(consts, dtype=f.I64, device=dev).unbind(0)
    den = f.add(f.sub(f.qm31_mul_m31(A, xs), f.qm31_mul_m31(B, ys)), C)
    num = f.qm31_zero((rows,), dev)
    for j, c in enumerate(cols):
        num = f.add(num, f.qm31_mul_m31(g[j], c.to(f.I64)))
    num = f.sub(f.sub(num, f.qm31_mul_m31(acc_a, xs)), acc_c0)
    q = f.qm31_mul(num, f.qm31_inv(den))
    if acc is not None:
        q = f.add(acc.to(f.I64), q)
    return q.to(f.I32)


# ---------------------------------------------------------------------------
# K5 / K6 and the check: the component tape on the trace domain and on the
# commit domain.


def _check_rows(cols: Sequence[torch.Tensor], n: int, what: str) -> None:
    for c in cols:
        _require(c.dtype == f.I32 and tuple(c.shape) == (n,), f"{what}: columns must be int32 ({n},)")


def _ptrs(cols: Sequence[torch.Tensor], device: torch.device) -> List[int]:
    for c in cols:
        _require(c.device == device and c.is_contiguous(), "columns must be contiguous, on one device")
    return [c.data_ptr() for c in cols]


def _air_kind(tp, family: str) -> int:
    """The compiled `family` ("witness" or "domain") function of `tp`'s
    component; raises when none is compiled from this tape."""
    kind, digest = compiled_air_tapes().get((family, tp.name), (None, None))
    _require(kind is not None and digest == tape_digest(tp),
             f"air_{family}({tp.name}): no compiled {family} tape for this tape (csrc/{AIR_TAPES_HEADER}; regenerate "
             "it with python3 -m luminair_tpu_torch.air.tape_cuda)")
    return kind


def _addr(t: torch.Tensor, dev: torch.device, n: int, what: str) -> int:
    _require(t.dtype == f.I32 and tuple(t.shape) == (n,), f"{what}: columns must be int32 ({n},)")
    _require(t.device == dev and t.is_contiguous(), f"{what}: every column of a launch on one device, contiguous")
    return t.data_ptr()


def _witness_table(comps: Sequence[tuple]):
    """Validates a witness launch's components (`air_witness_many`) in one
    pass over their columns; returns (each one's compiled function, its
    column addresses: main, then pp; their device)."""
    _require(0 < len(comps) <= AIR_MAX_COMPS, f"air_witness: 1 to {AIR_MAX_COMPS} components, got {len(comps)}")
    c0 = comps[0]
    dev = (list(c0[1]) + list(c0[2]))[0].device
    kinds, ptrs, n_cols = [], [], 0
    for tp, main, pp, *carry in comps:
        _require(len(main) == tp.n_main and len(pp) == tp.n_pp, f"air_witness({tp.name}): column count")
        _require(tp.n_constraints == 0, f"air_witness({tp.name}): a witness tape (tape.record(comp, witness=True))")
        kinds.append(_air_kind(tp, "witness"))
        n = (list(main) + list(pp))[0].shape[0]
        _log2(n)
        ptrs.append([_addr(c, dev, n, "air_witness") for c in (*main, *pp)])
        n_cols += len(ptrs[-1])
        if carry and carry[0] is not None:
            _require(carry[0].dtype == f.I32 and tuple(carry[0].shape) == (4,) and carry[0].device == dev
                     and carry[0].is_contiguous(), "air_witness: a carry is (4,) contiguous int32 beside the columns")
    _require(n_cols <= AIR_MAX_COLS, f"air_witness: {n_cols} columns, a launch takes {AIR_MAX_COLS}")
    return kinds, ptrs, dev


def witness_items(rows: int) -> int:
    """Rows a thread of a K5 tile for a launch of `rows` rows in all
    (WITNESS_ITEMS_AT): a large launch's look-backs, one a tile, cost less
    the more rows a tile has; a small launch keeps its tiles to fill the
    card."""
    return next((items for at, items in WITNESS_ITEMS_AT if rows >= at), 1)


def _witness_args(comps, kinds, ptrs, ew, outs, claimed: torch.Tensor, threads: int = WITNESS_THREADS,
                  items: Optional[int] = None) -> WitnessArgs:
    """The launch's table (`_witness_table`'s kinds and addresses): each
    component's columns in `cols` from its col0, its tiles of `items`
    rounds of `threads` rows (by default `witness_items`) from its tile0,
    its output outs[c], its carry; the scratch fields are the caller's."""
    items = witness_items(sum(o.shape[1] for o in outs)) if items is None else items
    rows = items * threads
    a = WitnessArgs()
    a.claimed, a.n_comps, a.rows, a.items = claimed.data_ptr(), len(comps), rows, items
    a.elems[:] = [w for kind in ew for q in kind for w in q]
    col = tile = 0
    for slot, kind, mine, c, out in zip(a.comps, kinds, ptrs, comps, outs):
        a.cols[col : col + len(mine)] = mine
        n = out.shape[1]
        carry = c[3] if len(c) > 3 else None
        slot.n, slot.out, slot.kind, slot.col0, slot.tile0 = n, out.data_ptr(), kind, col, tile
        slot.last = out.data_ptr() + 4 * (out.shape[0] - 4) * n
        slot.carry = carry.data_ptr() if carry is not None else 0
        col, tile = col + len(mine), tile + -(-n // rows)
    a.n_tiles = tile
    return a


class _ScanScratch:
    """K5's look-back state on one device: one int64 buffer -- the tile
    counter (2 words), a flag word a tile, then 4 words a tile for its
    aggregate and inclusive prefix (8 int32) --, made zero when made (and
    made anew, larger, for a launch of more tiles than it holds); the
    counter's value before the next launch and the last launch's epoch.
    The kernel never clears it: each launch's flags carry its epoch."""

    def __init__(self, dev: torch.device):
        self.dev, self.cap, self.buf, self.base, self.epoch = dev, 0, None, 0, 0

    def fill(self, a: WitnessArgs) -> None:
        if a.n_tiles > self.cap:
            self.cap = max(a.n_tiles, 2 * self.cap, 1024)
            self.cap += self.cap % 2  # the sums 16-byte aligned
            self.buf = torch.zeros(2 + 5 * self.cap, dtype=torch.int64, device=self.dev)
            self.base = 0
        p = self.buf.data_ptr()
        self.epoch += 1
        a.counter, a.flags, a.sums = p, p + 16, p + 16 + 8 * self.cap
        a.base, a.epoch = self.base, self.epoch


_SCAN_SCRATCH: Dict[torch.device, _ScanScratch] = {}


def air_witness_many(comps: Sequence[tuple], ew):
    """The LogUp interaction of several components in one launch (see
    csrc/air.cuh): (outs, claimed) -- each component's (4E, N) int32 (row
    4b + k is coordinate k of entry b, the last entry summed down the rows)
    and a (C, 4) int32 whose row c is component c's claimed sum.

    comps: (tp, main, pp) or (tp, main, pp, carry) each: its witness tape
    (`tape.record(comp, witness=True)`), its padded columns int32 (N,) in
    MAIN / PP_IDS order, every column of the launch on one device; with a
    carry (4 words beside the columns) its columns are a row block of a
    larger trace and its last entry's sums start from the carry (the sum
    of every earlier block), its claimed sum then the block's last row.  ew:
    `tape.element_words` of the drawn lookup elements.  At most
    AIR_MAX_COMPS components and AIR_MAX_COLS columns."""
    kinds, ptrs, dev = _witness_table(comps)
    if dev.type == "cpu":
        return air_witness_many_plain(comps, ew)
    _require(dev.type == "cuda", f"unsupported device {dev}")
    outs = [torch.empty((4 * c[0].n_relations, (list(c[1]) + list(c[2]))[0].shape[0]), dtype=f.I32, device=dev)
            for c in comps]
    claimed = torch.empty((len(comps), 4), dtype=f.I32, device=dev)
    a = _witness_args(comps, kinds, ptrs, ew, outs, claimed)
    key = f.device_key(dev)
    if key not in _SCAN_SCRATCH:
        _SCAN_SCRATCH[key] = _ScanScratch(key)
    st = _SCAN_SCRATCH[key]
    st.fill(a)
    AIR_WITNESS.launch("lum_air_witness", dev, ctypes.addressof(a))
    st.base += a.n_tiles
    return outs, claimed


def air_witness_many_plain(comps: Sequence[tuple], ew):
    from .air import tape as tp_mod

    done = [tp_mod.witness_plain(c[0], c[1], c[2], ew, c[3] if len(c) > 3 else None) for c in comps]
    return [out for out, _ in done], torch.stack([claimed for _, claimed in done])


def air_witness(tp, main: Sequence[torch.Tensor], pp: Sequence[torch.Tensor], ew, carry=None):
    """The LogUp interaction of one component on its trace domain: (4E, N)
    int32 and its claimed sum (4,) int32 -- the case of one component of
    `air_witness_many`, with its carry when given."""
    outs, claimed = air_witness_many([(tp, main, pp) + ((carry,) if carry is not None else ())], ew)
    return outs[0], claimed[0]


def add_carry(rows, carry: torch.Tensor):
    """K5's carry pass, in place: each (4, R) block of `rows` (the last
    relation entry's sums of a row block: a tensor, or a list of them)
    plus its QM31 carry, coordinate by coordinate.  carry: int32 on the
    blocks' device, (C, 4) for a list of C blocks (row c is block c's),
    (4,) for one tensor.  On the card, one launch for the whole list."""
    blocks = [rows] if isinstance(rows, torch.Tensor) else list(rows)
    _require(0 < len(blocks) <= CARRY_MAX_BLOCKS, f"add_carry: 1 to {CARRY_MAX_BLOCKS} blocks, got {len(blocks)}")
    for b in blocks:
        _require(b.dtype == f.I32 and b.dim() == 2 and b.shape[0] == 4 and b.is_contiguous(),
                 "add_carry: rows (4, R) contiguous int32")
    want = (4,) if isinstance(rows, torch.Tensor) else (len(blocks), 4)
    _require(carry.dtype == f.I32 and tuple(carry.shape) == want and carry.is_contiguous()
             and all(b.device == carry.device for b in blocks),
             f"add_carry: carry {want} contiguous int32 on the blocks' device")
    if _on_cpu(carry):
        return add_carry_plain(rows, carry)
    a = CarryArgs()
    a.carry, a.n_blocks = carry.data_ptr(), len(blocks)
    ctas = 0
    for slot, b in zip(a.blocks, blocks):
        R = b.shape[1]
        vec = R % 4 == 0 and b.data_ptr() % 16 == 0
        row_ctas = max(1, -(-(R // 4 if vec else R) // CARRY_THREADS))
        slot.rows, slot.len, slot.row_ctas, slot.vec, slot.cta0 = b.data_ptr(), R, row_ctas, int(vec), ctas
        ctas += 4 * row_ctas
    a.n_ctas = ctas
    ADD_CARRY.launch("lum_m31_add_carry", carry.device, ctypes.addressof(a))
    return rows


def add_carry_plain(rows, carry: torch.Tensor):
    blocks = [rows] if isinstance(rows, torch.Tensor) else list(rows)
    for b, c in zip(blocks, carry.reshape(-1, 4)):
        b.copy_(f.add(b.to(f.I64), c.to(f.I64)[:, None]).to(f.I32))
    return rows


@dataclass
class DomainTerm:
    """One component's share of a K6 launch: its tape (`tape.record`), its
    columns on the domain or row block -- main and pp in MAIN / PP_IDS
    order, its 4E interaction coordinates, is_first, each int32 (M,) --,
    its claimed sum (4 words), its K + E alpha powers
    (`fields.qm31_powers_ints`) and, on a row block, its halo = (next
    {main index: the (stride,) rows after the block} for every column read
    at the next row, prev [the (stride,) rows before the block of each of
    the last entry's 4 coordinates]), which wrap at the domain's ends."""

    tp: object
    main: list
    pp: list
    inter: list
    is_first: torch.Tensor
    claimed: tuple
    pows: list
    halo: Optional[tuple] = None


@dataclass
class DomainBlock:
    """One commit domain D_log_domain (M = 2^log_domain rows; log_domain =
    log_trace + its log blowup), or the row block [row0, row0 + M) of it, with
    every component whose domain it is; stride = 2^blowup rows a trace
    step."""

    terms: list
    log_trace: int
    stride: int
    row0: int = 0
    log_domain: Optional[int] = None

    @property
    def rows(self) -> int:
        return self.terms[0].is_first.shape[0]


def _halo_or_wrap(tp, halo, what: str) -> None:
    _require(halo is None or (len(halo[1]) == 4 and set(halo[0]) == set(tp.next_cols)),
             f"{what}({tp.name}): a halo has the rows after the block of every column read at the next row "
             "and the rows before it of the last entry's 4 coordinates")


_U64 = (1 << 64) - 1


def _domain_table(blocks: Sequence[DomainBlock]):
    """Validates a K6 launch (`air_domain_many`) in one pass over its
    columns; returns (each term's compiled function, its column addresses:
    main, pp, inter, is_first, then its halo columns offset as
    csrc/tape_row.cuh reads them; the device)."""
    n_terms = sum(len(b.terms) for b in blocks)
    _require(blocks and all(b.terms for b in blocks) and n_terms <= AIR_MAX_COMPS,
             f"air_domain: 1 to {AIR_MAX_COMPS} components, got {n_terms}")
    dev = blocks[0].terms[0].is_first.device
    kinds, ptrs, n_cols, n_pows = [], [], 0, 0
    for blk in blocks:
        m, stride, halo = blk.rows, blk.stride, blk.terms[0].halo is not None
        log = _log2(m)
        log_domain = log if blk.log_domain is None else blk.log_domain
        _require(0 < stride <= m and blk.log_trace >= 1 and (halo or stride < m), "air_domain: bad stride or trace log")
        _require(0 <= blk.row0 and blk.row0 % m == 0 and blk.row0 + m <= 1 << log_domain
                 and (halo or m == 1 << log_domain), "air_domain: a row block lies in its domain and has a halo")
        for t in blk.terms:
            tp = t.tp
            _require(len(t.main) == tp.n_main and len(t.pp) == tp.n_pp and len(t.inter) == 4 * tp.n_relations,
                     f"air_domain({tp.name}): column count")
            _require(len(t.pows) == tp.n_pows, f"air_domain({tp.name}): {tp.n_pows} alpha powers")
            _require((t.halo is not None) == halo, "air_domain: every component of a block has a halo, or none")
            _halo_or_wrap(tp, t.halo, "air_domain")
            kinds.append(_air_kind(tp, "domain"))
            mine = [_addr(c, dev, m, "air_domain") for c in (*t.main, *t.pp, *t.inter, t.is_first)]
            if halo:
                nxt, prev = t.halo
                mine += [(_addr(nxt[x], dev, stride, "the halo") - 4 * m) & _U64 for x in tp.next_cols]
                mine += [_addr(c, dev, stride, "the halo") + 4 * stride for c in prev]
            else:  # the block's own columns: the reads wrap
                mine += [(_addr(t.main[x], dev, m, "air_domain") - 4 * m) & _U64 for x in tp.next_cols]
                mine += [_addr(c, dev, m, "air_domain") + 4 * m for c in t.inter[-4:]]
            ptrs.append(mine)
            n_cols += len(mine)
            n_pows += tp.n_pows
    _require(n_cols <= AIR_MAX_COLS and n_pows <= AIR_MAX_POWS,
             f"air_domain: {n_cols} columns and {n_pows} alpha powers, a launch takes {AIR_MAX_COLS} and "
             f"{AIR_MAX_POWS}")
    return kinds, ptrs, dev


def _domain_args(blocks, kinds, ptrs, ew, outs, threads: int = DOMAIN_THREADS) -> DomainArgs:
    """The launch's table (`_domain_table`'s kinds and addresses): a span a
    block, its components from comp0, its rows in CTAs of `threads` from
    its cta0 into outs[i]."""
    a = DomainArgs()
    a.elems[:] = [w for kind in ew for q in kind for w in q]
    a.n_spans = len(blocks)
    col = comp = pw = cta = 0
    for span, blk, out in zip(a.spans, blocks, outs):
        m = blk.rows
        log_domain = _log2(m) if blk.log_domain is None else blk.log_domain
        span.n, span.out, span.stride, span.log_trace = m, out.data_ptr(), blk.stride, blk.log_trace
        span.xs = circle.domain_table(log_domain, out.device)[0].data_ptr() + 4 * blk.row0
        span.comp0, span.n_comps, span.cta0 = comp, len(blk.terms), cta
        for t in blk.terms:
            slot, mine = a.comps[comp], ptrs[comp]
            a.cols[col : col + len(mine)] = mine
            slot.kind, slot.col0, slot.pow0 = kinds[comp], col, pw
            slot.claimed[:] = list(f.qm31_words(t.claimed))
            a.pows[4 * pw : 4 * (pw + len(t.pows))] = [w for q in t.pows for w in q]
            col, comp, pw = col + len(mine), comp + 1, pw + len(t.pows)
        cta += -(-m // threads)
    a.n_ctas = cta
    return a


def air_domain_many(blocks: Sequence[DomainBlock], ew) -> List[torch.Tensor]:
    """K6 of several commit domains (or row blocks) in one launch (see
    csrc/air.cuh): each block's (M, 4) int32 constraint quotients, the sum
    over its components of sum_i pows[i] * C_i over their K recorded and E
    LogUp constraints, divided by V_n(x) of the row.  ew: the lookup
    elements' words.  Every column on one device; at most AIR_MAX_COMPS
    components, AIR_MAX_COLS columns (halo columns included) and
    AIR_MAX_POWS alpha powers."""
    kinds, ptrs, dev = _domain_table(blocks)
    if dev.type == "cpu":
        return air_domain_many_plain(blocks, ew)
    _require(dev.type == "cuda", f"unsupported device {dev}")
    outs = [torch.empty((b.rows, 4), dtype=f.I32, device=dev) for b in blocks]
    a = _domain_args(blocks, kinds, ptrs, ew, outs)
    AIR_DOMAIN.launch("lum_air_domain", dev, ctypes.addressof(a))
    return outs


def air_domain_many_plain(blocks: Sequence[DomainBlock], ew) -> List[torch.Tensor]:
    from .air import tape as tp_mod

    outs = []
    for b in blocks:
        total = None
        for t in b.terms:
            total = tp_mod.domain_plain(t.tp, t.main, t.pp, t.inter, t.is_first, f.qm31_words(t.claimed), ew, t.pows,
                                        b.log_trace, b.stride, total, b.row0, b.log_domain, t.halo)
        outs.append(total)
    return outs


def air_domain(tp, main, pp, inter, is_first: torch.Tensor, claimed, ew, pows, log_trace: int,
               stride: int, row0: int = 0, log_domain: Optional[int] = None, halo=None) -> torch.Tensor:
    """Constraint quotients (M, 4) int32 of one component on its commit
    domain D_log, M = 2^log.  A row block: the columns hold rows [row0, row0 +
    M) of D_log_domain and `halo` = (next, prev) their neighbours' rows
    (`DomainTerm`), which wrap at the domain's ends; M at least `stride`.
    The case of one component of `air_domain_many`."""
    blk = DomainBlock([DomainTerm(tp, list(main), list(pp), list(inter), is_first, claimed, list(pows), halo)],
                      log_trace, stride, row0, log_domain)
    return air_domain_many([blk], ew)[0]


def air_check(tp, main, pp, inter, is_first: torch.Tensor, claimed, ew) -> torch.Tensor:
    """Which of a component's constraints fail where on its trace domain:
    (N,) int32, bit i of row r set when constraint i does not vanish at r --
    the K recorded constraints in tape order, then entry b's LogUp
    constraint as bit K + b (see csrc/check.cuh).  Next row r + 1,
    previous row r - 1, cyclic.

    main / pp: the component's padded trace columns int32 (N,) in MAIN /
    PP_IDS order; inter: its 4E interaction coordinates (`air_witness`);
    is_first: the trace domain's is_first column; claimed: 4 words.  The
    case of one component of `air_check_many`."""
    return air_check_many([(tp, main, pp, inter, is_first, claimed)], ew)


def _check_kind(tp) -> int:
    """The compiled check tape of `tp`'s component; raises when none is
    compiled from this tape."""
    kind, digest = compiled_check_tapes().get(tp.name, (None, None))
    _require(kind is not None and digest == tape_digest(tp),
             f"air_check({tp.name}): no compiled check tape for this tape (csrc/{CHECK_TAPES_HEADER}; regenerate it "
             "with python3 -m luminair_tpu_torch.air.tape_cuda)")
    return kind


def _check_table(comps: Sequence[tuple]):
    """Validates a check's components (`air_check_many`) in one pass over
    their columns; returns (each one's compiled tape, each one's column
    addresses: main, pp, inter, is_first; their device)."""
    _require(0 < len(comps) <= CHECK_MAX_COMPS, f"air_check: 1 to {CHECK_MAX_COMPS} components, got {len(comps)}")
    dev = comps[0][4].device
    kinds, ptrs, n_cols = [], [], 0
    for tp, main, pp, inter, is_first, _ in comps:
        n = is_first.shape[0]
        _log2(n)
        if len(main) != tp.n_main or len(pp) != tp.n_pp or len(inter) != 4 * tp.n_relations:
            raise KernelError(f"air_check({tp.name}): column count")
        if tp.n_pows > TAPE_MAX_POWS:
            raise KernelError(f"air_check({tp.name}): {tp.n_pows} constraints, a word holds 32")
        kinds.append(_check_kind(tp))
        shape, mine = (n,), []
        for c in (*main, *pp, *inter, is_first):
            if c.dtype != f.I32 or c.shape != shape:
                raise KernelError(f"air_check: columns must be int32 ({n},)")
            if c.device != dev or not c.is_contiguous():
                raise KernelError("air_check: every column of a check on one device, contiguous")
            mine.append(c.data_ptr())
        ptrs.append(mine)
        n_cols += len(mine)
    _require(n_cols <= CHECK_MAX_COLS, f"air_check: {n_cols} columns, a launch takes {CHECK_MAX_COLS}")
    return kinds, ptrs, dev


def air_check_many(comps: Sequence[tuple], ew) -> torch.Tensor:
    """The check of several components (`air_check`) in one launch: their
    words one after another, (sum of N,) int32.  comps: (tp, main, pp,
    inter, is_first, claimed) of each, as `air_check` takes them, every
    column on one device; at most CHECK_MAX_COMPS components and
    CHECK_MAX_COLS columns in all (main, pp, inter and is_first)."""
    kinds, ptrs, dev = _check_table(comps)
    if dev.type == "cpu":
        return air_check_many_plain(comps, ew)
    _require(dev.type == "cuda", f"unsupported device {dev}")
    out = torch.empty(sum(c[4].shape[0] for c in comps), dtype=f.I32, device=dev)
    a = _check_args(comps, kinds, ptrs, ew, out)
    AIR_CHECK.launch("lum_air_check", dev, ctypes.addressof(a))
    return out


def _check_args(comps, kinds: Sequence[int], ptrs: Sequence[List[int]], ew, out: torch.Tensor) -> CheckArgs:
    """The launch's table (`_check_table`'s kinds and addresses): each
    component's columns in `cols` from its col0, its rows from its cta0 in
    CTAs of CHECK_THREADS and from word `out` of out."""
    a = CheckArgs()
    a.out, a.n_comps = out.data_ptr(), len(comps)
    a.elems[:] = [w for kind in ew for q in kind for w in q]
    col = cta = row = 0
    for slot, kind, mine, c in zip(a.comps, kinds, ptrs, comps):
        a.cols[col : col + len(mine)] = mine
        n = c[4].shape[0]
        slot.n, slot.out, slot.kind, slot.col0, slot.cta0 = n, row, kind, col, cta
        slot.claimed[:] = list(f.qm31_words(c[5]))
        col, cta, row = col + len(mine), cta + -(-n // CHECK_THREADS), row + n
    a.n_ctas = cta
    return a


def air_check_many_plain(comps: Sequence[tuple], ew) -> torch.Tensor:
    from .air import tape as tp_mod

    return torch.cat([tp_mod.check_plain(tp, main, pp, inter, is_first, f.qm31_words(claimed), ew)
                      for tp, main, pp, inter, is_first, claimed in comps])


# ---------------------------------------------------------------------------
# K7: OODS values.


@dataclass
class OodsPlan:
    """The host's plan of one K7 call: the descriptor of csrc/oods.cuh
    (int64 words; column addresses included), and the sizes that follow
    from it."""

    desc: np.ndarray
    n_units: int  # one QM31 partial each: (column, chunk)
    n_rows: int
    smem_words: int  # the largest group's basis tables


def _oods_plan(groups, chunk_log: int = OODS_CHUNK_LOG) -> OodsPlan:
    _require(0 <= chunk_log <= 16, "oods_eval_many: chunk log in 0..16")
    recs, ptrs, units, rows, smem = [], [], 0, 0, 0
    for cols, chain in groups:
        log = _log2(cols[0].shape[0])
        c = min(log, chunk_log)
        a = (log - c + 1) // 2
        rec = np.zeros(OODS_GROUP_WORDS, dtype=np.int64)
        rec[:6] = (log, c, a, len(cols), rows, units)
        rec[6 : 6 + 4 * log] = [w for q in chain for w in f.qm31_words(q)]
        recs.append(rec)
        ptrs += [col.data_ptr() for col in cols]
        units += len(cols) << (log - c)
        rows += len(cols)
        smem = max(smem, (4 << c) + (4 << a) + (4 << (log - c - a)))
    desc = np.concatenate([np.array([len(groups), units, rows], dtype=np.int64)] + recs
                          + [np.array(ptrs, dtype=np.int64)])
    return OodsPlan(desc, units, rows, smem)


def _sm_count(dev) -> int:
    return _sm_count_of(f.device_key(dev))


@functools.lru_cache(maxsize=None)
def _sm_count_of(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def oods_eval_many(groups: Sequence[tuple]) -> torch.Tensor:
    """(sum C, 4) int32: for each group (C M31 coefficient columns of length
    N = 2^L, the L QM31 words of its point's `fft.twiddle_chain`) its C
    values at the point, groups in order.  On the card: one upload of the
    plan's descriptor, two launches for the whole call."""
    groups = [(list(cols), chain) for cols, chain in groups]
    _require(len(groups) > 0 and all(len(cols) > 0 for cols, _ in groups), "oods_eval_many: empty group")
    for cols, chain in groups:
        n = cols[0].shape[0]
        log = _log2(n)
        _require(len(chain) == log and log <= OODS_MAX_LOG, f"oods_eval_many: chain of {log} points expected")
        _check_rows(cols, n, "oods_eval_many")
    ref = groups[0][0][0]
    if _on_cpu(ref):
        return oods_eval_many_plain(groups)
    dev = ref.device
    for cols, _ in groups:
        _ptrs(cols, dev)
    plan = _oods_plan(groups)
    words = f.upload(plan.desc, dev)
    partial = torch.empty(4 * plan.n_units, dtype=f.I32, device=dev)
    out = torch.empty((plan.n_rows, 4), dtype=f.I32, device=dev)
    ctas = min(-(-plan.n_units // OODS_LANE_GROUPS), 4 * _sm_count(dev))  # four CTAs per SM measured fastest
    OODS_EVAL.launch("lum_oods_eval", dev, words.data_ptr(), ctas, plan.n_rows, 4 * plan.smem_words,
                     partial.data_ptr(), out.data_ptr())
    return out


def oods_eval_many_plain(groups: Sequence[tuple]) -> torch.Tensor:
    return torch.cat([oods_eval_plain(cols, chain) for cols, chain in groups])


def oods_eval_plain(cols: Sequence[torch.Tensor], chain: Sequence[tuple]) -> torch.Tensor:
    """One group's (C, 4) values.  The basis by doubling (entry j: the product of chain[L-1-i] over the
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


# ---------------------------------------------------------------------------
# K8: the Blake2s channel on the card (each FRI layer's step in K2's root
# pass, `merkle_tree`); K10: the proof-of-work search.


def _check_words(t: Optional[torch.Tensor], n: int, what: str, device: torch.device) -> None:
    if t is not None:
        _require(t.dtype == f.I32 and tuple(t.shape) == (n,) and t.is_contiguous() and t.device == device,
                 f"{what}: {n} contiguous int32 words on the state's device")


def channel_draw_felt(state: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw one QM31 from the channel `state` (CHANNEL_WORDS int32 words:
    digest, counter, alpha; see csrc/channel.cuh), updated in place; the
    alpha is also written to `out` (4 words) when given.  Returns state."""
    _check_words(state, CHANNEL_WORDS, "channel state", state.device)
    _check_words(out, 4, "channel_draw_felt out", state.device)
    if _on_cpu(state):
        return channel_draw_felt_plain(state, out)
    CHANNEL.launch("lum_channel_draw_felt", state.device, state.data_ptr(), out.data_ptr() if out is not None else None)
    return state


def _hash_plain(words: torch.Tensor) -> torch.Tensor:
    """Blake2s of one message of int32 words -> (8,) int64 words."""
    return f.to_u32_i64(blake2s.hash_words_plain(words[None]))[0]


def channel_draw_felt_plain(state, out=None):
    digest = state[:8]
    counter = int(state[8]) & 0xFFFFFFFF
    taken = []
    while len(taken) < 4:
        le64 = f.to_i32(torch.tensor([counter, 0], dtype=f.I64, device=state.device))
        counter += 1
        for w in _hash_plain(torch.cat([digest, le64])).tolist():
            if w < 2 * f.P:  # 0xFFFFFFFE and 0xFFFFFFFF are rejected
                taken.append(w % f.P)
                if len(taken) == 4:
                    break
    state[8:] = f.to_i32(torch.tensor([counter] + taken, dtype=f.I64, device=state.device))
    if out is not None:
        out.copy_(state[9:])
    return state


def channel_mix_root_draw_plain(state, root, out=None):
    """K8's step on a root (8 int32 words): the twin of a channel tree's
    root pass (merkle_tree with a state and a slot); `out` (12 words)
    receives the root and the alpha when given.  Returns state."""
    state[:8] = f.to_i32(_hash_plain(torch.cat([state[:8], root])))
    state[8] = 0
    channel_draw_felt_plain(state)
    if out is not None:
        out[:8] = root
        out[8:] = state[9:]
    return state


def pow_limit(bits: int) -> int:
    """The search's end: 4096 times a `bits`-bit search's expected work."""
    return 1 << min(bits + 12, 62)


def pow_ctas(bits: int, sms: int) -> int:
    """K10's grid: POW_CTAS_PER_SM CTAs an SM (a round of 33,792 nonces on
    132 SMs), or fewer while a round of POW_ROUND_WORK times the expected
    2^bits candidates takes fewer, so a low-bit search hashes one small
    round and not a card's width (at 5 bits: 2 CTAs, 256 nonces)."""
    return max(1, min(POW_CTAS_PER_SM * sms, (POW_ROUND_WORK << min(bits, 40)) // POW_THREADS))


def _digest_words(digest: bytes) -> np.ndarray:
    _require(isinstance(digest, bytes) and len(digest) == 32, "grind_pow: a 32-byte digest")
    return np.frombuffer(digest, dtype="<u4")


class _PowScratch:
    """K10's state on one device: two scratch words on the card (all ones
    when made; each launch puts the other parity's word back), the parity
    of the next launch, and the pinned word a result comes down to.  One
    search at a time a device: the wrapper waits for each."""

    def __init__(self, dev: torch.device):
        self.words = f.to_device(torch.tensor([-1, -1], dtype=torch.int64), dev)
        self.parity = 0
        self.result = torch.empty(1, dtype=torch.int64, pin_memory=True)
        self.value = self.result.numpy()


_POW_SCRATCH: Dict[torch.device, _PowScratch] = {}


def _pow_search(digest: bytes, bits: int, run) -> int:
    """A search's result: `run(PowArgs)` sets the scratch address and
    parity, launches it and returns its result word; all ones means no
    nonce below the limit, which raises."""
    limit = pow_limit(bits)
    args = PowArgs((ctypes.c_uint32 * 8)(*_digest_words(digest).tolist()), limit, 0, bits, 0)
    hit = run(args)
    if hit == -1:
        raise KernelError(f"grind_pow: no {bits}-bit nonce below {limit}")
    return hit


def grind_pow(digest: bytes, bits: int, device) -> int:
    """The smallest nonce whose H(digest || LE64(nonce)) has `bits` low
    zero bits in its first 8 bytes (LE64): Blake2sChannel.grind_pow's
    nonce, searched below `pow_limit(bits)` (KernelError beyond).  digest:
    the channel's 32 bytes.  On a CUDA `device` one launch (the digest
    among its parameters), one 8-byte copy into pinned memory and one
    stream synchronise; on the CPU the twin."""
    _require(0 <= bits <= 64, "grind_pow: bits in 0..64")
    device = torch.device(device)
    if device.type == "cpu":
        return grind_pow_plain(digest, bits, device)
    _require(device.type == "cuda", f"unsupported device {device}")
    device = f.device_key(device)
    if device not in _POW_SCRATCH:
        _POW_SCRATCH[device] = _PowScratch(device)
    st = _POW_SCRATCH[device]
    ctas = pow_ctas(bits, _sm_count(device))

    def run(args: PowArgs) -> int:
        args.scratch, args.parity = st.words.data_ptr(), st.parity
        GRIND_POW.launch("lum_grind_pow", device, ctypes.addressof(args), ctas, st.result.data_ptr())
        tracing.count(tracing.D2H, st.result.element_size())  # the entry point's copy of the result word
        st.parity ^= 1
        return int(st.value[0])

    return _pow_search(digest, bits, run)


def grind_pow_plain(digest: bytes, bits: int, device="cpu") -> int:
    words = f.u32_to_tensor(_digest_words(digest), device, f.I64)
    limit = pow_limit(bits)
    chunk = 1 << 13  # (4, chunk) rows stay under torch's parallel grain
    lo_mask = (1 << min(bits, 32)) - 1
    hi_mask = (1 << max(bits - 32, 0)) - 1
    for start in range(0, limit, chunk):
        nonces = torch.arange(start, min(start + chunk, limit), dtype=f.I64, device=words.device)
        n = len(nonces)
        msgs = torch.cat([words.expand(n, 8), (nonces & 0xFFFFFFFF)[:, None], (nonces >> 32)[:, None]], dim=1)
        h = f.to_u32_i64(blake2s.hash_words_plain(f.to_i32(msgs)))
        hit = torch.nonzero(((h[:, 0] & lo_mask) == 0) & ((h[:, 1] & hi_mask) == 0))
        if len(hit):
            return start + int(hit[0, 0])
    raise KernelError(f"grind_pow: no {bits}-bit nonce below {limit}")


# ---------------------------------------------------------------------------
# K9: one decommitment pass.


class TreeDesc:
    """What a decommitment pass needs of one Merkle tree, made once when the
    tree is built: its digest layers {log: (2^log, 8)}, log 0 .. bottom,
    its column views {log: (k, 2^log), any strides}, and the descriptor of
    csrc/decommit.cuh on their device (one upload on the card)."""

    def __init__(self, layers: Dict[int, torch.Tensor], cols_by_log: Dict[int, torch.Tensor]):
        self.layers = layers
        self.cols = cols_by_log
        self.bottom = max(layers)
        _require(self.bottom <= DC_MAX_LOG, f"decommit: trees of at most 2^{DC_MAX_LOG} leaves")
        self.k = np.zeros(self.bottom + 1, dtype=np.int64)
        for log, c in cols_by_log.items():
            self.k[log] = c.shape[0]
        d = np.zeros(DC_DESC_WORDS, dtype=np.int64)
        d[0] = self.bottom
        rows = d[1 : 1 + 5 * (self.bottom + 1)].reshape(-1, 5)
        for log, layer in layers.items():
            _require(layer.dtype == f.I32 and layer.is_contiguous() and tuple(layer.shape) == (1 << log, 8),
                     "decommit: contiguous int32 (2^log, 8) digest layers")
            rows[log, 0] = layer.data_ptr()
        for log, c in cols_by_log.items():
            _require(c.dtype == f.I32 and c.dim() == 2 and c.shape[1] == 1 << log, "decommit: (k, 2^log) columns")
            rows[log, 1:] = (c.data_ptr(), c.shape[0], c.stride(0), c.stride(1))
        self.words = f.upload(d, layers[self.bottom].device)


class DecommitPass:
    """One opening pass over several trees, planned on the host without a
    set: `queries[t]` maps a log of tree t to its sorted, distinct query
    positions (numpy).  Holds the upper bounds that size each tree's part
    of the output, the one int64 upload of the card (a record per tree, the
    positions), and `split` for the downloaded words."""

    def __init__(self, trees: Sequence[TreeDesc], queries: Sequence[Dict[int, np.ndarray]]):
        _require(len(trees) == len(queries) and len(trees) > 0, "decommit: one query map per tree")
        self.trees = list(trees)
        self.dev = trees[0].layers[trees[0].bottom].device
        _require(all(t.layers[t.bottom].device == self.dev for t in trees), "decommit: trees on one device")
        n = len(trees)
        counts = np.zeros((n, DC_MAX_LOG + 1), dtype=np.int64)
        parts, limits = [], []
        for t, (tree, qs) in enumerate(zip(trees, queries)):
            for log in sorted(qs):  # the order of the records' offsets
                pos = qs[log]
                _require(0 <= log <= tree.bottom, f"decommit: queries at log {log} of a tree of bottom {tree.bottom}")
                pos = np.asarray(pos, dtype=np.int64).reshape(-1)
                counts[t, log] = len(pos)
                parts.append(pos)
                limits.append(np.full(len(pos), 1 << log, dtype=np.int64))
        self.positions = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        q_off = np.cumsum(counts.reshape(-1)) - counts.reshape(-1)
        # Range and order, checked before launch: each (tree, log) run of
        # positions in [0, 2^log), strictly increasing.
        limit = np.concatenate(limits) if limits else np.zeros(0, np.int64)
        _require(bool(((self.positions >= 0) & (self.positions < limit)).all()), "decommit: positions out of range")
        starts = np.zeros(len(self.positions), dtype=bool)
        starts[q_off.reshape(n, -1)[counts > 0]] = True
        step_ok = np.diff(self.positions, prepend=-1) > 0
        _require(bool((step_ok | starts).all()), "decommit: positions not sorted and distinct")
        self.queries = [{log: self.positions[q_off[t * (DC_MAX_LOG + 1) + log]:][: counts[t, log]]
                         for log in qs} for t, qs in enumerate(queries)]

        # Upper bounds per log, from the counts: |comp[l]| <= min(2^l,
        # queries at logs >= l); witnesses of layer l <= min(2^l, |comp[l]|
        # + 2 |q[l-1]|); the merge holds |comp[l]| + |q[l-1]|.
        self.region = []  # per tree: (header, witness, values offsets, bottom)
        caps, sizes, off = [1], [], 0
        for t, tree in enumerate(trees):
            L = tree.bottom
            qc = counts[t, : L + 1]
            size = np.int64(1) << np.arange(L + 1, dtype=np.int64)
            cb = np.minimum(size, np.cumsum(qc[::-1])[::-1])
            wb = np.minimum(size[1:], cb[1:] + 2 * qc[:-1])
            caps += [int(cb[L]), int((cb[1:] + 2 * qc[:-1]).max(initial=0))]
            hdr = off
            wit = hdr + 2 * (L + 1)
            val = wit + 8 * int(wb.sum())
            off = val + int((tree.k * cb).sum())
            sizes.append(off - hdr)
            self.region.append((hdr, wit, val, L))
        self.n_words = off
        self.cap = max(caps)
        # A CTA's three position lists live in shared memory when they fit,
        # else in a device-memory scratch area of the same size per CTA.
        self.in_shared = 3 * self.cap * 4 <= DC_SHARED_BYTES
        self.slices = min(16, -(-max(sizes) // 16384))  # CTAs per tree: one per 16K words of output
        rec = np.zeros((n, DC_TREE_WORDS), dtype=np.int64)
        rec[:, 1:4] = [r[:3] for r in self.region]
        rec[:, 4::2] = q_off.reshape(n, -1)
        rec[:, 5::2] = counts
        rec[:, 0] = [tree.words.data_ptr() for tree in trees]
        self.packed = np.concatenate([rec.reshape(-1), self.positions])

    def split(self, words: np.ndarray) -> List[tuple]:
        """The pass's downloaded words -> per tree (opened values: one array
        per column, logs descending, commitment order; witness: (n, 8)
        digests), numpy views."""
        out = []
        for tree, (hdr, wit, val, L) in zip(self.trees, self.region):
            h = words[hdr : hdr + 2 * (L + 1)].astype(np.int64).reshape(L + 1, 2)  # logs L .. 0
            witness = words[wit : wit + 8 * int(h[:, 1].sum())].reshape(-1, 8)
            values = []
            for log in sorted(tree.cols, reverse=True):
                k, c = int(tree.k[log]), int(h[L - log, 0])
                values.extend(words[val : val + k * c].reshape(k, c))
                val += k * c
            out.append((values, witness))
        return out

    def split_layers(self, words: np.ndarray) -> List[tuple]:
        """`split` by layer: per tree ({log: the opened values of its
        columns, commitment order}, {layer: (n, 8) witness digests, the
        children on that layer}), numpy views."""
        out = []
        for (values, witness), tree, (hdr, _, _, L) in zip(self.split(words), self.trees, self.region):
            h = words[hdr : hdr + 2 * (L + 1)].astype(np.int64).reshape(L + 1, 2)
            vals, it = {}, iter(values)
            for log in sorted(tree.cols, reverse=True):
                vals[log] = [next(it) for _ in range(int(tree.k[log]))]
            ends = np.cumsum(h[:, 1])
            out.append((vals, {L - i: witness[ends[i] - h[i, 1] : ends[i]] for i in range(L + 1)}))
        return out


def decommit(plan: DecommitPass) -> torch.Tensor:
    """The pass's output words (int32, on the trees' device): per tree a
    header of (recomputed count, witness count) per log, bottom first, then
    the witness digests and the opened values (csrc/decommit.cuh).  On the
    card: one pinned upload, one launch."""
    if plan.dev.type == "cpu":
        return decommit_plain(plan)
    _require(plan.dev.type == "cuda", f"unsupported device {plan.dev}")
    out = torch.zeros(plan.n_words, dtype=f.I32, device=plan.dev)
    packed = f.upload(plan.packed, plan.dev)
    scratch = None if plan.in_shared else torch.empty(len(plan.trees) * plan.slices * 3 * plan.cap, dtype=f.I32,
                                                      device=plan.dev)
    DECOMMIT.launch("lum_decommit", plan.dev, packed.data_ptr(), len(plan.trees), plan.slices, plan.cap,
                    scratch.data_ptr() if scratch is not None else None, out.data_ptr())
    return out


def decommit_plain(plan: DecommitPass) -> torch.Tensor:
    """The same pass with torch set operations (torch.unique, torch.isin,
    index_select), tree by tree, layer by layer."""
    dev = plan.dev
    out = torch.zeros(plan.n_words, dtype=f.I32, device=dev)
    for tree, qs, (hdr, wit, val, L) in zip(plan.trees, plan.queries, plan.region):
        def q(log):
            return torch.as_tensor(qs.get(log, np.zeros(0, np.int64)), device=dev)

        comp = q(L)
        heads = []
        for log in range(L, -1, -1):
            if log < L:
                new = torch.unique(torch.cat([comp >> 1, q(log)]))
                kids = torch.stack([2 * new, 2 * new + 1], dim=1).reshape(-1)
                missing = kids[~torch.isin(kids, comp)]
                digests = tree.layers[log + 1].index_select(0, missing).reshape(-1)
                out[wit : wit + len(digests)] = digests
                wit += len(digests)
                heads[-1][1] = len(missing)
                comp = new
            heads.append([len(comp), 0])
            if log in tree.cols:
                v = tree.cols[log].index_select(1, comp).reshape(-1)
                out[val : val + len(v)] = v
                val += len(v)
        out[hdr : hdr + 2 * (L + 1)] = torch.tensor(heads, dtype=f.I32, device=dev).reshape(-1)
    return out


# ---------------------------------------------------------------------------
# logup_sum: a row shard's LogUp claimed sum (parallel/sharding.py).


LOGUP_CTAS_PER_SM = 4
# logup_sum's partials and finish counter on each device (`cuda:i`).
_LOGUP_SCRATCH: Dict[torch.device, torch.Tensor] = {}


class LogupPlan:
    """logup_sum's launch parameters for one (z, alpha, K), built once and
    used for any number of row blocks: z's words and alpha's K powers, and
    per device a LogupArgs with the scratch, K, z and the powers filled,
    the C entry point and the CTA cap.  A call writes only the values,
    multiplicities, output, row count and row stride, and launches; the
    launch copies the parameters, so the next call may rewrite them."""

    def __init__(self, z, alpha, k: int):
        _require(1 <= k <= LOGUP_MAX_K, f"logup_sum: 1 to {LOGUP_MAX_K} relation columns, got {k}")
        self.k, self.z, self.alpha = k, _words(z), _words(alpha)
        self.pows = [w for q in f.qm31_powers_ints((1, 0, 0, 0), self.alpha, k)[0] for w in q]
        self._on: Dict[torch.device, tuple] = {}

    def args(self) -> "LogupArgs":
        """A LogupArgs with K, z and the powers filled (no pointers)."""
        a = LogupArgs(k=self.k)
        a.z[:] = self.z
        a.pows[: 4 * self.k] = self.pows
        return a

    def _device(self, dev: torch.device) -> tuple:
        got = self._on.get(dev)
        if got is None:
            cap = LOGUP_CTAS_PER_SM * _sm_count(dev)
            if dev not in _LOGUP_SCRATCH:
                _LOGUP_SCRATCH[dev] = torch.zeros(4 * cap + 1, dtype=f.I32, device=dev)
            a = self.args()
            a.partial = _LOGUP_SCRATCH[dev].data_ptr()
            got = self._on[dev] = (a, ctypes.addressof(a), LOGUP_SUM._load()["lum_logup_sum"], cap)
        return got

    def __call__(self, values: torch.Tensor, mult: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(4,) int32 QM31: sum_i mult_i / (z - sum_k alpha^k values[k, i]),
        written into `out` when given (a contiguous (4,) int32 on the
        values' device, e.g. a row of a result of several blocks).
        values: (K, n) int32 M31 words, each row contiguous (any row
        stride); mult: (n,) int32 M31 words on the same device.  The
        inverse of 0 is 0."""
        if not (values.dtype == f.I32 and values.dim() == 2 and values.stride(1) == 1
                and values.shape[0] == self.k):
            raise KernelError(f"logup_sum: values must be ({self.k}, n) int32 with contiguous rows")
        n = values.shape[1]
        if not (n > 0 and mult.dtype == f.I32 and mult.shape == (n,) and mult.is_contiguous()
                and mult.device == values.device):
            raise KernelError(f"logup_sum: mult must be ({n},) contiguous int32 beside the values")
        if out is not None and not (out.dtype == f.I32 and out.shape == (4,) and out.is_contiguous()
                                    and out.device == values.device):
            raise KernelError("logup_sum: out must be (4,) contiguous int32 beside the values")
        if _on_cpu(values):
            got = logup_sum_plain(values, mult, self.z, self.alpha)
            return got if out is None else out.copy_(got)
        dev = values.device
        a, ptr, fn, cap = self._device(dev)
        if out is None:
            out = torch.empty(4, dtype=f.I32, device=dev)
        a.values, a.mult, a.out, a.n, a.stride = values.data_ptr(), mult.data_ptr(), out.data_ptr(), n, values.stride(0)
        LOGUP_SUM.run(fn, dev, ptr, min(-(-n // LOGUP_THREADS), cap))
        return out


def logup_sum(values: torch.Tensor, mult: torch.Tensor, z, alpha) -> torch.Tensor:
    """(4,) int32 QM31: sum_i mult_i / (z - sum_k alpha^k values[k, i])
    (LogupPlan; a caller with several row blocks of one (z, alpha) builds
    the plan once).  values: (K, n) int32 M31 words, each row contiguous;
    mult: (n,) int32 on the same device; z, alpha: QM31 (4 words).  On the
    card: one launch, its CTAs' partials added by the last one, in a
    scratch kept per device (its counter zeroed when made and reset by
    each launch's last CTA: one stream a device)."""
    _require(values.dim() == 2, "logup_sum: values must be (K, n) int32 with contiguous rows")
    return LogupPlan(z, alpha, values.shape[0])(values, mult)


def logup_sum_plain(values: torch.Tensor, mult: torch.Tensor, z, alpha) -> torch.Tensor:
    dev = values.device
    acc = torch.tensor(_words(z), dtype=f.I64, device=dev).expand(values.shape[1], 4)
    apow = (1, 0, 0, 0)
    for row in values:
        acc = f.sub(acc, f.qm31_mul_m31(torch.tensor(apow, dtype=f.I64, device=dev), f.to_u32_i64(row)))
        apow = f.qm31_mul_ints(apow, _words(alpha))
    frac = f.qm31_mul_m31(f.qm31_inv(acc), f.to_u32_i64(mult))
    return (frac.sum(0) % f.P).to(f.I32)


# ---------------------------------------------------------------------------
# T1+T2 (trace_segment), T3, T4: trace generation.

NEG1 = (1 << 31) - 2  # -1 in M31
_BINARY_OPS = ("add", "mul", "rem", "less_than")
_UNARY_OPS = ("inputs", "recip", "square", "sqrt", "lut", "contiguous")


@dataclass
class TraceStep:
    """One node of the trace interpreter as a trace kernel takes it.

    srcs: (int64 buffer, View) per operand; rows: the rows the node writes
    (outputs for a reduction); out: its int64 output buffer; cols: int32
    views of its rows of the table's columns, by name (empty: values only,
    as in the settings pre-pass); mult: the int32 histogram column it
    counts into (LUT or range check); flag: an int32 word set to 1 when an
    input is out of range; lut: (lo, hi, start, outputs) int64 tensors of
    a LUT op's settings."""

    op: str
    srcs: List[tuple]
    rows: int
    out: Optional[torch.Tensor] = None
    cols: Dict[str, torch.Tensor] = field(default_factory=dict)
    ids: tuple = (0, 0, 0)  # node, lhs / input, rhs
    out_mult: int = 0
    in_mult: int = NEG1
    dsize: int = 1  # reductions: the reduced axis, and the elements after it
    back: int = 1
    lut: Optional[tuple] = None
    mult: Optional[torch.Tensor] = None
    flag: Optional[torch.Tensor] = None

    def fresh(self) -> "TraceStep":
        """The same step writing into new zeroed outputs."""
        def z(t):
            return None if t is None else torch.zeros_like(t)

        return replace(self, out=z(self.out), cols={k: z(v) for k, v in self.cols.items()},
                       mult=z(self.mult), flag=z(self.flag))

    def outputs(self) -> torch.Tensor:
        """Everything the step writes, as one int64 vector."""
        parts = [self.out] + [self.cols[k] for k in sorted(self.cols)] + [self.mult, self.flag]
        return torch.cat([p.reshape(-1).to(torch.int64) for p in parts if p is not None])


@functools.lru_cache(maxsize=4096)
def _view_bytes(view, length: int) -> bytes:
    """The ViewDesc of `view` over a buffer of `length` elements."""
    ndim, sizes, strides, los, his, base, magic, shift = view.packed()
    v = ViewDesc()
    v.strides[:ndim], v.sizes[:ndim], v.magic[:ndim], v.shift[:ndim] = strides, sizes, magic, shift
    v.lo[:ndim], v.hi[:ndim] = los, his
    v.base, v.len, v.ndim = base, length, ndim
    return bytes(v)


def _trace_args(s: TraceStep, dev: torch.device) -> TraceArgs:
    a = TraceArgs()
    _require(s.op in TRACE_OPS, f"trace: unknown op {s.op}")
    for k, (buf, view) in enumerate(s.srcs):
        _require(buf.dtype == torch.int64 and buf.device == dev and buf.is_contiguous() and buf.dim() == 1,
                 "trace: sources must be contiguous int64 vectors on one device")
        a.view[k] = ViewDesc.from_buffer_copy(_view_bytes(view, len(buf)))
        a.src[k] = buf.data_ptr()
    if s.out is not None:
        _require(s.out.dtype == torch.int64 and s.out.device == dev and s.out.is_contiguous(),
                 "trace: out must be a contiguous int64 tensor")
        a.out = s.out.data_ptr()
    n_rows = s.rows * s.dsize  # dsize is 1 but for reductions
    for k, (name, col) in enumerate(s.cols.items()):
        _require(name in TRACE_COLS, f"trace: no kernel writes column {name}")
        _require(col.dtype == f.I32 and col.device == dev and col.is_contiguous() and len(col) == n_rows,
                 f"trace: column {name} must be {n_rows} contiguous int32 rows on the sources' device")
        a.cols[k if s.op == "pad" else TRACE_COLS.index(name)] = col.data_ptr()
    if s.lut is not None:
        lo, hi, start, outs = s.lut
        _require(all(t.dtype == torch.int64 and t.device == dev and t.is_contiguous() for t in s.lut),
                 "trace: LUT tables must be contiguous int64 on the sources' device")
        a.lut_lo, a.lut_hi, a.lut_start, a.lut_out = (t.data_ptr() for t in (lo, hi, start, outs))
        a.n_ranges, a.lut_n = len(lo), len(outs)
    for name in ("mult", "flag"):
        t = getattr(s, name)
        if t is not None:
            _require(t.dtype == f.I32 and t.device == dev and t.is_contiguous(), f"trace: {name} must be int32")
            setattr(a, name, t.data_ptr())
    a.n, a.op, a.dsize, a.back = s.rows, TRACE_OPS.index(s.op), s.dsize, s.back
    if s.op == "pad":  # column after column: word r is row r % rows of column r / rows
        a.n = s.rows * len(s.cols)
        a.view[0].sizes[1] = s.rows
        a.view[0].magic[1], a.view[0].shift[1] = fast_divmod(max(s.rows, 1))
    _require(n_rows < 1 << 31 and a.n < 1 << 31, f"trace: {a.n} rows; a launch takes fewer than 2^31 an item")
    if s.op == "contiguous":
        a.n_in, a.n_out = len(s.srcs[0][0]), s.srcs[0][1].n_elements
    a.node_id, a.id0, a.id1 = s.ids
    a.out_mult, a.in_mult = s.out_mult, s.in_mult
    return a


# A pass's node table: the rows of trace_segment's launches.

_ARGS_DTYPE = np.dtype(TraceArgs)
_VIEW_DTYPE = np.dtype(ViewDesc)
_CHAIN_DTYPE = np.dtype(SegChain)
_PHASE_DTYPE = np.dtype(SegPhase)
_OP_CODE = {op: i for i, op in enumerate(TRACE_OPS)}


@dataclass
class TraceItem:
    """One row range of a pass's node table: a T1 or T2 node's rows, a
    table's padding rows (op "pad", writing `out_mult` into each column of
    `columns`), or an input's fixed encoding (op "encode": word r of its
    source, the bits of a double, to word r of `out`), by arena offsets and
    names.

    srcs: ((arena offset, length, View), ...); fresh: the sources that its
    launch writes before it (read past the L1 cache); out: (arena offset,
    length) of its int64 output, or None; table, row0: the trace table it
    writes and its first row there (None: values only); columns: a padding
    item's columns (None for a node: all of its table's); lut: the LUT kind
    whose tables it reads; hist: the histogram it counts into; flag: the
    flag word it may set (-1: none)."""

    op: str
    rows: int
    srcs: tuple = ()
    fresh: tuple = ()
    out: Optional[tuple] = None
    table: Optional[str] = None
    row0: int = 0
    columns: Optional[tuple] = None
    ids: tuple = (0, 0, 0)
    out_mult: int = 0
    in_mult: int = NEG1
    lut: Optional[str] = None
    hist: Optional[str] = None
    flag: int = -1


@functools.lru_cache(maxsize=256)
def _column_slots(names: tuple, columns: Optional[tuple]) -> np.ndarray:
    """Each TRACE_COLS slot's index into a table's `names` (-1: none): a
    node's columns each in its own slot (columns None), a padding item's
    `columns` in the first slots."""
    idx = np.full(len(TRACE_COLS), -1, np.int64)
    if columns is None:
        idx[[TRACE_COLS.index(c) for c in names]] = np.arange(len(names))
    else:
        idx[: len(columns)] = [names.index(c) for c in columns]
    idx.flags.writeable = False
    return idx


def _kernel_rows(it: TraceItem) -> int:
    """The rows the kernel runs for an item: a padding item's words."""
    return it.rows * len(it.columns) if it.op == "pad" else it.rows


@dataclass
class TraceBuffers:
    """A pass's memory on its device: the int64 arena (node outputs, then
    the uploaded inputs, constants, LUT tables and node table), each trace
    table's padded int32 columns {table: (column names, (columns, rows))},
    the int32 histograms by name, the int32 flag words, and each LUT's
    (lo, hi, start, outputs) as (arena offset, length) pairs."""

    arena: torch.Tensor
    storage: Dict[str, tuple] = field(default_factory=dict)
    hists: Dict[str, torch.Tensor] = field(default_factory=dict)
    flags: Optional[torch.Tensor] = None
    luts: Dict[str, tuple] = field(default_factory=dict)

    def zeroed(self, regions) -> "TraceBuffers":
        """A copy with the arena's `regions` ((offset, length) pairs), every
        column, histogram and flag set to 0."""
        arena = self.arena.clone()
        for off, n in regions:
            arena[off : off + n] = 0
        z = torch.zeros_like
        return TraceBuffers(arena, {k: (names, z(st)) for k, (names, st) in self.storage.items()},
                            {k: z(h) for k, h in self.hists.items()},
                            None if self.flags is None else z(self.flags), self.luts)


class NodeTable:
    """The node table of one pass: `items` in table order, `chains` ((first
    item, count) each: items of the same rows, each reading the current
    phase's outputs only at its own row, from earlier items of its chain),
    `phases` ((first chain, count) each; no chain of a phase reads another's
    output), `segments` ((first phase, end phase) each, one launch each),
    packed as int64 words at arena offset `at`: the TraceArgs rows, the
    SegChain rows (each chain's first tile in its phase), the SegPhase rows,
    the barrier words."""

    def __init__(self, buffers: TraceBuffers, items: List[TraceItem], chains: List[tuple], phases: List[tuple],
                 segments: List[tuple], at: int):
        self.buffers, self.items, self.chains, self.phases = buffers, items, chains, phases
        self.segments, self.at = segments, at
        self.tiles, self.shifts = zip(*(_chain_tiles(_kernel_rows(items[first])) if count else (0, 0)
                                        for first, count in chains)) if chains else ((), ())

    @staticmethod
    def n_words(n_items: int, n_chains: int, n_phases: int) -> int:
        return (n_items * _ARGS_DTYPE.itemsize + n_chains * _CHAIN_DTYPE.itemsize
                + n_phases * _PHASE_DTYPE.itemsize) // 8 + 1

    def pack(self) -> np.ndarray:
        """The table's words, with every address on the buffers' device."""
        b, items, n = self.buffers, self.items, len(self.items)
        base = b.arena.data_ptr()
        rec = np.zeros(n, _ARGS_DTYPE)
        if n:
            rec["op"] = [_OP_CODE[it.op] for it in items]
            rec["n"] = [_kernel_rows(it) for it in items]
            rec["node_id"], rec["id0"], rec["id1"] = np.array([it.ids for it in items], dtype=np.int64).T
            rec["out_mult"] = [it.out_mult for it in items]
            rec["in_mult"] = [it.in_mult for it in items]
            rec["out"] = [base + 8 * it.out[0] if it.out else 0 for it in items]
            rec["flag"] = [b.flags.data_ptr() + 4 * it.flag if it.flag >= 0 else 0 for it in items]
            rec["mult"] = [b.hists[it.hist].data_ptr() if it.hist else 0 for it in items]
            srcs, views = rec["src"], rec["view"]
            for i, it in enumerate(items):
                for k, (off, length, view) in enumerate(it.srcs):
                    srcs[i, k] = base + 8 * off
                    views[i, k] = np.frombuffer(_view_bytes(view, length), _VIEW_DTYPE)[0]
                    views["fresh"][i, k] = k in it.fresh
                if it.op == "contiguous":
                    rec["n_in"][i], rec["n_out"][i] = it.srcs[0][1], it.srcs[0][2].n_elements
                elif it.op == "pad":
                    views["sizes"][i, 0, 1] = it.rows
                    views["magic"][i, 0, 1], views["shift"][i, 0, 1] = fast_divmod(max(it.rows, 1))
                if it.lut:
                    (lo, n_ranges), hi, start, (outs, lut_n) = b.luts[it.lut]
                    rec["lut_lo"][i], rec["lut_hi"][i] = base + 8 * lo, base + 8 * hi[0]
                    rec["lut_start"][i], rec["lut_out"][i] = base + 8 * start[0], base + 8 * outs
                    rec["n_ranges"][i], rec["lut_n"][i] = n_ranges, lut_n
            rec["cols"] = self._columns()
        rec["dsize"], rec["back"] = 1, 1
        chains = np.zeros(len(self.chains), _CHAIN_DTYPE)
        phases = np.zeros(len(self.phases), _PHASE_DTYPE)
        for p, (first, count) in enumerate(self.phases):
            t = np.asarray(self.tiles[first : first + count], dtype=np.int64)
            chains[first : first + count] = [(*self.chains[c], t0, self.shifts[c], 0)
                                             for c, t0 in zip(range(first, first + count), np.cumsum(t) - t)]
            phases[p] = (first, count, int(t.sum()))
        return np.concatenate([rec.view(np.int64), chains.view(np.int64), phases.view(np.int64),
                               np.zeros(1, np.int64)])

    def _columns(self) -> np.ndarray:
        """(items, TRACE_COLS) column addresses: the table's storage + (its
        column index x padded rows + the item's first row) x 4 bytes, in the
        column's slot (a padding item's columns in its first slots), 0 where
        the item writes no such column."""
        idx, layout = [], []
        for it in self.items:
            if it.table is None:
                idx.append(_column_slots((), None))
                layout.append((0, 0, 0))
                continue
            names, st = self.buffers.storage[it.table]
            idx.append(_column_slots(tuple(names), it.columns))
            layout.append((st.data_ptr(), st.shape[1], it.row0))
        ptr, size, row0 = np.array(layout, dtype=np.int64).T[:, :, None]
        idx = np.stack(idx)
        return np.where(idx >= 0, ptr + 4 * (idx * size + row0), 0).astype(np.uint64)

    def upload(self) -> None:
        """Pack and copy the table alone into its place in the arena."""
        w = self.pack()
        f.copy(self.buffers.arena[self.at : self.at + len(w)], torch.from_numpy(w))

    def segment(self, k: int) -> "TraceSegment":
        return TraceSegment(self, *self.segments[k])

    def phase_tiles(self, p: int) -> int:
        first, count = self.phases[p]
        return sum(self.tiles[first : first + count])

    def step(self, it: TraceItem) -> TraceStep:
        """An item as the plain twins take it: slices of the buffers."""
        b = self.buffers
        arena = b.arena
        cols = {}
        if it.table is not None:
            names, st = b.storage[it.table]
            cols = {c: st[i, it.row0 : it.row0 + it.rows] for i, c in enumerate(names)
                    if it.columns is None or c in it.columns}
        return TraceStep(
            op=it.op, srcs=[(arena[o : o + n], v) for o, n, v in it.srcs], rows=it.rows,
            out=arena[it.out[0] : it.out[0] + it.out[1]] if it.out else None, cols=cols, ids=it.ids,
            out_mult=it.out_mult, in_mult=it.in_mult,
            lut=tuple(arena[o : o + n] for o, n in b.luts[it.lut]) if it.lut else None,
            mult=b.hists[it.hist] if it.hist else None,
            flag=b.flags[it.flag : it.flag + 1] if it.flag >= 0 else None,
        )


@dataclass
class TraceSegment:
    """Phases [p0, p1) of a pass's node table: one launch of trace_segment."""

    table: NodeTable
    p0: int
    p1: int

    def items(self) -> List[TraceItem]:
        t = self.table
        if self.p1 <= self.p0:
            return []
        c0 = t.phases[self.p0][0]
        c1 = sum(t.phases[self.p1 - 1])
        return t.items[t.chains[c0][0] : sum(t.chains[c1 - 1])] if c1 > c0 else []

    @property
    def has_columns(self) -> bool:
        return any(it.table is not None for it in self.items())

    def steps(self) -> List[TraceStep]:
        return [self.table.step(it) for it in self.items()]

    def args(self) -> SegArgs:
        t = self.table
        nodes = t.buffers.arena.data_ptr() + 8 * t.at
        chains = nodes + _ARGS_DTYPE.itemsize * len(t.items)
        phases = chains + _CHAIN_DTYPE.itemsize * len(t.chains)
        barrier = phases + _PHASE_DTYPE.itemsize * len(t.phases)
        tiles = max((t.phase_tiles(p) for p in range(self.p0, self.p1)), default=0)
        return SegArgs(nodes, chains, phases, barrier, tiles, self.p0, self.p1)

    def fresh(self) -> "TraceSegment":
        """The same segment over a copy of the buffers in which everything
        it writes is 0 (its node table packed and uploaded anew)."""
        t = self.table
        b = t.buffers.zeroed([it.out for it in self.items() if it.out])
        table = NodeTable(b, t.items, t.chains, t.phases, t.segments, t.at)
        table.upload()
        return TraceSegment(table, self.p0, self.p1)

    def outputs(self) -> torch.Tensor:
        """Everything the segment writes, as one int64 vector: its items'
        outputs, the columns of the tables it writes, histograms, flags."""
        b = self.table.buffers
        items = self.items()
        parts = [b.arena[o : o + n] for o, n in (it.out for it in items if it.out)]
        parts += [b.storage[name][1].reshape(-1) for name in sorted({it.table for it in items if it.table})]
        parts += [b.hists[k] for k in sorted(b.hists)] + ([b.flags] if b.flags is not None else [])
        return torch.cat([p.to(torch.int64) for p in parts]) if parts else torch.zeros(0, dtype=torch.int64)


def trace_segment(seg: TraceSegment) -> None:
    """T1+T2: every item of a segment of a pass's node table (its phases in
    order) in one cooperative launch (see trace.cu); none for a segment of
    no rows."""
    arena = seg.table.buffers.arena
    if _on_cpu(arena):
        return trace_segment_plain(seg)
    args = seg.args()
    if args.max_tiles > 0:
        TRACE_SEGMENT.launch("lum_trace_segment", arena.device, ctypes.addressof(args))


def _launch_one(s: TraceStep) -> None:
    """One step as a segment of its own (one phase of one chain): its
    TraceArgs row, the chain, the phase and the barrier words in one
    upload, one launch."""
    dev = s.srcs[0][0].device
    a = _trace_args(s, dev)
    tiles, shift = _chain_tiles(a.n)
    if tiles == 0:
        return
    chain = np.array([(0, 1, 0, shift, 0)], _CHAIN_DTYPE)
    phase = np.array([(0, 1, tiles)], _PHASE_DTYPE)
    words = f.to_device(torch.from_numpy(np.concatenate([np.frombuffer(bytes(a), np.int64), chain.view(np.int64),
                                                         phase.view(np.int64), np.zeros(1, np.int64)])), dev)
    chains = words.data_ptr() + ctypes.sizeof(TraceArgs)
    phases = chains + _CHAIN_DTYPE.itemsize
    args = SegArgs(words.data_ptr(), chains, phases, phases + _PHASE_DTYPE.itemsize, tiles, 0, 1)
    TRACE_SEGMENT.launch("lum_trace_segment", dev, ctypes.addressof(args))


def trace_binary(s: TraceStep) -> None:
    """T1: add / mul / rem / less_than rows of one node, as a one-node
    segment (see trace.cu)."""
    _require(s.op in _BINARY_OPS and len(s.srcs) == 2, f"trace_binary: op {s.op}")
    if _on_cpu(s.srcs[0][0]):
        return trace_binary_plain(s)
    _launch_one(s)


def trace_unary(s: TraceStep) -> None:
    """T2: inputs / recip / square / sqrt / lut / contiguous rows of one
    node, as a one-node segment."""
    _require(s.op in _UNARY_OPS and len(s.srcs) == 1, f"trace_unary: op {s.op}")
    _require(s.op != "lut" or s.lut is not None, "trace_unary: a LUT op needs its tables")
    if _on_cpu(s.srcs[0][0]):
        return trace_unary_plain(s)
    _launch_one(s)


def trace_encode(s: TraceStep) -> None:
    """An input's fixed encoding (fixed.from_float) from its float64 bits,
    as a one-item segment."""
    _require(s.op == "encode" and len(s.srcs) == 1 and s.out is not None and len(s.out) >= s.rows
             and len(s.srcs[0][0]) >= s.rows and not s.cols, "trace_encode: one source, an output, no columns")
    if _on_cpu(s.srcs[0][0]):
        return trace_encode_plain(s)
    _launch_one(s)


def trace_reduce(s: TraceStep) -> None:
    """T3: sum_reduce / max_reduce rows of one node, `rows` outputs."""
    _require(s.op in ("sum_reduce", "max_reduce") and len(s.srcs) == 1, f"trace_reduce: op {s.op}")
    _require(s.rows * s.dsize == s.srcs[0][1].n_elements, "trace_reduce: outputs x dsize must cover the view")
    if _on_cpu(s.srcs[0][0]):
        return trace_reduce_plain(s)
    dev = s.srcs[0][0].device
    a = _trace_args(s, dev)
    TRACE_REDUCE.launch("lum_trace_reduce", dev, ctypes.addressof(a))


def lut_boundary_words(n: int, gn: int) -> int:
    """Words of the staging region T4 needs for a source of n and a gathered
    input of gn int64 values: the result, then (when the source takes
    several CTAs) the CTAs' partials and a counter (csrc/lut.cuh)."""
    ctas = min(max(1, -(-n // (2 * LUT_PAIRS * LUT_THREADS))), LUT_MAX_CTAS)
    return gn + 2 + (2 * ctas + 1 if ctas > 1 else 0)


def lut_boundary(src: torch.Tensor, gathered: torch.Tensor, staging: torch.Tensor) -> torch.Tensor:
    """T4: [min(src), max(src), gathered...] int64 into staging[: len(gathered)
    + 2], returned.  `staging` is a region the caller holds, zeroed once
    before its first use, of at least lut_boundary_words(len(src),
    len(gathered)) words: its tail is the kernel's scratch, which every
    launch leaves as it found it."""
    _require(src.dtype == gathered.dtype == staging.dtype == torch.int64
             and src.dim() == gathered.dim() == staging.dim() == 1 and len(src) > 0,
             "lut_boundary: int64 vectors, a non-empty source")
    _require(src.is_contiguous() and gathered.is_contiguous() and staging.is_contiguous()
             and src.device == gathered.device == staging.device, "lut_boundary: contiguous vectors on one device")
    _require(len(staging) >= lut_boundary_words(len(src), len(gathered)), "lut_boundary: staging region too small")
    head = staging[: len(gathered) + 2]
    if _on_cpu(src):
        head.copy_(lut_boundary_plain(src, gathered))
        return head
    LUT_BOUNDARY.launch("lum_lut_boundary", src.device, src.data_ptr(), len(src), gathered.data_ptr(),
                        len(gathered), staging.data_ptr(), len(staging))
    return head


def trace_segment_plain(seg: TraceSegment) -> None:
    """The segment's items in table order, each through its op's twin."""
    for s in seg.steps():
        if s.op == "pad":
            trace_pad_plain(s)
        elif s.op == "encode":
            trace_encode_plain(s)
        elif s.op in _BINARY_OPS:
            trace_binary_plain(s)
        else:
            trace_unary_plain(s)


def trace_pad_plain(s: TraceStep) -> None:
    for col in s.cols.values():
        col.fill_(s.out_mult)


def trace_encode_plain(s: TraceStep) -> None:
    s.out[: s.rows] = fixed.t_from_float(s.srcs[0][0][: s.rows].view(torch.float64))


def _put(cols: Dict[str, torch.Tensor], name: str, value) -> None:
    if name in cols:
        if isinstance(value, torch.Tensor):
            cols[name].copy_(value)
        else:
            cols[name].fill_(value)


def _put_common(s: TraceStep, idx: torch.Tensor, last: int) -> None:
    node, id0, id1 = s.ids
    for name, v in (("node_id", node), ("next_node_id", node), ("lhs_id", id0), ("next_lhs_id", id0),
                    ("input_id", id0), ("next_input_id", id0), ("rhs_id", id1), ("next_rhs_id", id1)):
        _put(s.cols, name, v)
    _put(s.cols, "idx", idx)
    _put(s.cols, "next_idx", idx + 1)
    _put(s.cols, "is_last_idx", (idx == last).to(torch.int64))


def _count(s: TraceStep, pos: torch.Tensor) -> None:
    if s.mult is not None:
        s.mult += torch.bincount(pos, minlength=len(s.mult)).to(f.I32)


def trace_binary_plain(s: TraceStep) -> None:
    (abuf, av), (bbuf, bv) = s.srcs
    x, y = av.gather(abuf), bv.gather(bbuf)
    c = s.cols
    if s.op == "add":
        out = fixed.t_add(x, y)
        _put(c, "out", fixed.t_to_m31(out))
    elif s.op == "mul":
        out, rem = fixed.t_mul(x, y)
        _put(c, "out", fixed.t_to_m31(out))
        _put(c, "rem", fixed.t_to_m31(rem))
    elif s.op == "rem":
        q, out = fixed.t_div_rem(x, y)
        _put(c, "rem", fixed.t_to_m31(out))
        _put(c, "quotient", fixed.t_to_m31(q))
    else:
        out, borrow, diff = fixed.t_less_than(x, y)
        d = diff & 0xFFFFFFFF
        limbs = [(d >> (8 * k)) & 0xFF for k in range(4)]
        _put(c, "out", fixed.t_to_m31(out))
        _put(c, "borrow", borrow)
        _put(c, "diff", fixed.t_to_m31(diff))
        for k, limb in enumerate(limbs):
            _put(c, f"limb{k}", limb)
        _put(c, "range_check_mult", 1)
        _count(s, torch.cat(limbs))
    _put_common(s, torch.arange(len(x), device=x.device), s.rows - 1)
    _put(c, "lhs", fixed.t_to_m31(x))
    _put(c, "rhs", fixed.t_to_m31(y))
    _put(c, "lhs_mult", NEG1)
    _put(c, "rhs_mult", NEG1)
    _put(c, "out_mult", s.out_mult)
    if s.out is not None:
        s.out.copy_(out)


def trace_unary_plain(s: TraceStep) -> None:
    buf, view = s.srcs[0]
    c = s.cols
    rows = torch.arange(s.rows, device=buf.device)
    _put_common(s, rows, s.rows - 1)
    if s.op == "contiguous":
        n_in, n_out = len(buf), view.n_elements
        g = view.gather(buf)
        raw = torch.zeros(s.rows, dtype=torch.int64, device=buf.device)
        gathered = torch.zeros_like(raw)
        raw[:n_in], gathered[:n_out] = buf, g
        _put(c, "input", fixed.t_to_m31(raw))
        _put(c, "out", fixed.t_to_m31(gathered))
        _put(c, "input_mult", torch.where(rows < n_in, s.in_mult, 0))
        _put(c, "out_mult", torch.where(rows < n_out, s.out_mult, 0))
        if s.out is not None:
            s.out.copy_(g)
        return
    x = view.gather(buf)
    if s.op == "inputs":
        _put(c, "val", fixed.t_to_m31(x))
        _put(c, "multiplicity", s.out_mult)
        if s.out is not None:
            s.out.copy_(x)
        return
    if s.op == "recip":
        out, rem = fixed.t_recip(x)
    elif s.op == "square":
        out, rem = fixed.t_square(x)
    elif s.op == "sqrt":
        out, rem = fixed.t_sqrt(x)
    else:
        lo, hi, start, outs = s.lut
        pos = find_index_packed(x, lo, hi, start)
        if s.flag is not None and bool((pos < 0).any()):
            s.flag.fill_(1)
        pos = pos.clamp(0, len(outs) - 1)
        out, rem = outs[pos], None
        _put(c, "lookup_mult", 1)
        _count(s, pos)
    if rem is not None:
        _put(c, "rem", fixed.t_to_m31(rem))
    if s.op in ("recip", "sqrt"):
        _put(c, "scale", int(fixed.SCALE_FACTOR))
    _put(c, "input", fixed.t_to_m31(x))
    _put(c, "out", fixed.t_to_m31(out))
    _put(c, "input_mult", s.in_mult)
    _put(c, "out_mult", s.out_mult)
    if s.out is not None:
        s.out.copy_(out)


def trace_reduce_plain(s: TraceStep) -> None:
    buf, view = s.srcs[0]
    c = s.cols
    front = s.rows // s.back
    flat = view.gather(buf).reshape(front, s.dsize, s.back).transpose(1, 2).reshape(-1, s.dsize)
    last_step = (torch.arange(s.dsize, device=buf.device) == s.dsize - 1).repeat(s.rows)
    if s.op == "sum_reduce":
        run = torch.cumsum(flat, dim=1)
        before = run - flat
    else:
        run = torch.cummax(flat, dim=1).values
        before = torch.cat([flat[:, :1], run[:, :-1]], dim=1)
        is_max = flat > before
        ge = (run - torch.where(is_max, before, flat)).reshape(-1)
        if s.flag is not None and bool(((ge < 0) | (ge >= 1 << 30)).any()):
            s.flag.fill_(1)
        g = ge & 0xFFFFFFFF
        limbs = [g & 0xFF, (g >> 8) & 0xFF, (g >> 16) & 0xFF, (g >> 24) & 0x3F]
        _put(c, "is_max", is_max.reshape(-1).to(torch.int64))
        for k, limb in enumerate(limbs):
            _put(c, f"ge_limb{k}", limb)
        _put(c, "range_check_mult", 1)
        _count(s, torch.cat(limbs[:3] + [limbs[3] * 4]))
    outv = run[:, -1]
    _put_common(s, torch.arange(s.rows, device=buf.device).repeat_interleave(s.dsize), s.rows - 1)
    _put(c, "input", fixed.t_to_m31(flat.reshape(-1)))
    _put(c, "out", torch.where(last_step, fixed.t_to_m31(outv).repeat_interleave(s.dsize), 0))
    for name in ("acc", "max_val"):
        _put(c, name, fixed.t_to_m31(before.reshape(-1)))
    for name in ("next_acc", "next_max_val"):
        _put(c, name, fixed.t_to_m31(run.reshape(-1)))
    _put(c, "is_last_step", last_step.to(torch.int64))
    _put(c, "input_mult", s.in_mult)
    _put(c, "out_mult", torch.where(last_step, s.out_mult, 0))
    if s.out is not None:
        s.out.copy_(outv)


def lut_boundary_plain(src: torch.Tensor, gathered: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.stack([src.min(), src.max()]), gathered])
