"""The channel on the card (K8), the FRI commit chain and the proof-of-work
search (K10) of luminair_tpu_torch: their plain
twins against the reference's device programs (luminair_tpu.parallel.accel
on JAX's CPU) and host channel, and csrc/channel.cuh + csrc/blake2s.cuh
built with g++ against hashlib and the twins: the channel's steps, the
search's compression, and the search itself with its CTAs run in several
orders against the reference's grind."""

import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminair_tpu import fft as ref_fft
from luminair_tpu.crypto.channel import Blake2sChannel as RefChannel
from luminair_tpu.parallel import accel
from luminair_tpu_torch import fields as f
from luminair_tpu_torch import kernels
from luminair_tpu_torch.crypto.channel import Blake2sChannel
from luminair_tpu_torch.errors import KernelError
from luminair_tpu_torch.pcs import fri

P = (1 << 31) - 1


def _u32(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _state(digest, counter):
    s = np.zeros(kernels.CHANNEL_WORDS, dtype=np.uint32)
    s[:8], s[8] = digest, counter
    return f.u32_to_tensor(s)


def _ref_channel(digest, counter):
    ch = RefChannel()
    ch.digest, ch._counter = np.asarray(digest, dtype="<u4").tobytes(), counter
    return ch


CASES = [(seed, counter) for seed in range(12) for counter in (0, 1, 3, 250)]


def test_draw_felt_twin_matches_reference():
    """Over many digests and counters: the K8 twin's draw equals the
    reference's device draw (accel._jit_draw_felt) and its host channel."""
    run = accel._jit_draw_felt()
    for seed, counter in CASES:
        digest = _u32(np.random.default_rng(seed), 8)
        state = kernels.channel_draw_felt(_state(digest, counter))
        words = f.tensor_to_u32(state)
        alpha, ctr = run(jnp.asarray(digest), jnp.int32(counter))
        assert np.array_equal(words[9:], np.asarray(alpha)), (seed, counter)
        assert int(words[8]) == int(ctr)
        host = _ref_channel(digest, counter)
        assert np.array_equal(words[9:], host.draw_felt())
        assert int(words[8]) == host._counter and words[:8].tobytes() == host.digest


def test_mix_root_draw_twin_matches_reference():
    mix = jax.jit(accel._dev_mix_root)
    run = accel._jit_draw_felt()
    for seed, counter in CASES:
        rng = np.random.default_rng(100 + seed)
        digest, root = _u32(rng, 8), _u32(rng, 8)
        out = torch.zeros(12, dtype=torch.int32)
        state = kernels.channel_mix_root_draw_plain(_state(digest, counter), f.u32_to_tensor(root), out)
        words = f.tensor_to_u32(state)
        ref_digest = mix(jnp.asarray(digest), jnp.asarray(root))
        ref_alpha, ref_ctr = run(ref_digest, jnp.int32(0))
        assert np.array_equal(words[:8], np.asarray(ref_digest))
        assert np.array_equal(words[9:], np.asarray(ref_alpha)) and int(words[8]) == int(ref_ctr)
        assert np.array_equal(f.tensor_to_u32(out), np.concatenate([root, words[9:]]))
        host = _ref_channel(digest, counter)
        host.mix_root(root)
        assert np.array_equal(words[9:], host.draw_felt()) and int(words[8]) == host._counter


def _low_degree_inputs(logs, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for log in logs:
        coeffs = np.zeros((4, 1 << log), dtype=np.uint32)
        coeffs[:, ::2] = rng.integers(0, P, size=(4, 1 << (log - 1)), dtype=np.int64).astype(np.uint32)
        out[log] = np.ascontiguousarray(ref_fft.fft(coeffs).T)
    return out


@pytest.mark.parametrize("folds", [1, 2, 3])
def test_commit_chain_matches_reference_chain(folds, logs=(8, 7, 5)):
    """fri.commit_chain on CPU tensors against accel.fri_commit_chain at log
    8 with inputs of three sizes: final state, roots, alphas, alpha0, last
    layer."""
    inputs = _low_degree_inputs(logs, folds)
    B, bound = 1, 2
    digest = _u32(np.random.default_rng(9), 8).astype("<u4").tobytes()
    ref = accel.fri_commit_chain(inputs, B, bound, folds, B + bound, digest, 3)
    got = fri.commit_chain({k: f.u32_to_tensor(v) for k, v in inputs.items()}, B + bound, folds, digest, 3)
    assert got[0] == ref[0] and got[1] == ref[1]
    assert len(got[2]) == len(ref[2]) == len(fri.layer_schedule(8, B + bound, folds))
    for a, b in zip(got[2] + got[3], ref[2] + ref[3]):
        assert np.array_equal(a, np.asarray(b, dtype=np.uint32))
    assert np.array_equal(got[4], ref[4])
    assert np.array_equal(f.tensor_to_u32(got[5]), ref[5])
    assert not ref[6]  # no input below the last layer: no host tail


@pytest.mark.parametrize("folds", [2, 3])
def test_commit_chain_matches_reference_chain_with_gaps(folds):
    """The same at four input sizes, a gap between the largest two: the
    inputs of circle logs 6, 5 and 4 join at folds 1 and 2 of the first
    layer or in the next."""
    test_commit_chain_matches_reference_chain(folds, (8, 6, 5, 4))


def test_fri_prove_raises_on_a_diverged_channel(monkeypatch):
    """A device draw that differs from the host channel's is a ProverError."""
    from luminair_tpu_torch.errors import ProverError
    from luminair_tpu_torch.pcs.config import FriConfig

    inputs = {k: f.u32_to_tensor(v) for k, v in _low_degree_inputs((6,), 1).items()}
    draw = kernels.channel_mix_root_draw_plain

    def skewed(state, root, out=None):
        draw(state, root, out)
        out[8] ^= 1
        return state

    monkeypatch.setattr(kernels, "channel_mix_root_draw_plain", skewed)
    with pytest.raises(ProverError, match="diverged"):
        fri.fri_prove(inputs, FriConfig(log_last_layer_degree_bound=1), Blake2sChannel())


@pytest.mark.parametrize("fold", [0, 1, 3])
def test_fri_fold_chain_twin(fold):
    """A one-fold K3 layer with its challenge in device memory, taken up at
    fold index `fold`, is the host-scalar fold with beta = alpha^(2^fold)
    and, with an input joining, its circle fold scaled by beta^2."""
    rng = np.random.default_rng(fold)
    v = f.u32_to_tensor(rng.integers(0, P, (64, 4)).astype(np.uint32))
    tw = f.u32_to_tensor(rng.integers(0, P, 32).astype(np.uint32))
    mix = f.u32_to_tensor(rng.integers(0, P, (64, 4)).astype(np.uint32))
    mix_tw = f.u32_to_tensor(rng.integers(0, P, 32).astype(np.uint32))
    alpha = tuple(int(x) for x in rng.integers(0, P, 4))
    alpha0 = tuple(int(x) for x in rng.integers(0, P, 4))
    beta = alpha
    for _ in range(fold):
        beta = f.qm31_mul_ints(beta, beta)
    a, a0 = (f.u32_to_tensor(np.array(x, dtype=np.uint32)) for x in (alpha, alpha0))
    assert torch.equal(kernels.fri_layer(v, [tw], a, fold), kernels.fri_fold_plain(v, tw, beta))
    joined = kernels.fri_fold_plain(mix, mix_tw, alpha0)
    assert torch.equal(kernels.fri_layer(v, [tw], a, fold, [(mix, mix_tw)], a0),
                       kernels.fri_fold_plain(v, tw, beta, joined, f.qm31_mul_ints(beta, beta)))


@pytest.mark.parametrize("bits", [0, 1, 5, 9, 12, 16])
def test_grind_pow_twin_matches_reference(bits):
    digest = _u32(np.random.default_rng(bits), 8)
    nonce = kernels.grind_pow(digest.astype("<u4").tobytes(), bits, "cpu")
    assert nonce == _ref_channel(digest, 0).grind_pow(bits)
    if bits <= 12:
        ch = Blake2sChannel()
        ch.digest = digest.astype("<u4").tobytes()
        assert nonce == ch.grind_pow(bits)


# ---------------------------------------------------------------------------
# csrc/channel.cuh and csrc/blake2s.cuh, built with g++.

_SHIM = r"""
#include <algorithm>
#include <numeric>
#include <random>
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
#include "channel.cuh"
extern "C" long long h_channel_words() { return lum::CH_WORDS; }
extern "C" long long h_pow_args_size() { return sizeof(lum::PowArgs); }
extern "C" void h_compress(uint32_t* h, const uint32_t* m, uint32_t t, int last) { lum::blake2s_compress(h, m, t, last); }
extern "C" void h_init(uint32_t* h) { lum::blake2s_init(h); }
extern "C" int h_take_words(const uint32_t* block, uint32_t* out, int n) { return lum::take_words(block, out, n); }
extern "C" void h_draw_felt(uint32_t* state) { lum::draw_felt(state); }
extern "C" void h_mix_root(uint32_t* state, const uint32_t* root) { lum::mix_root(state, root); }
extern "C" void h_pow_h01(const uint32_t* digest, unsigned long long nonce, uint32_t* h) {
  uint32_t pre[16];
  lum::pow_prefix(digest, pre);
  lum::pow_h01(pre, digest, nonce, h[0], h[1]);
}
extern "C" int h_pow_ok(const uint32_t* digest, unsigned long long nonce, int bits) {
  uint32_t pre[16];
  lum::pow_prefix(digest, pre);
  return lum::pow_pass(pre, digest, nonce, lum::pow_mask(bits));
}
// One search launch of `grid` CTAs of T threads, each thread run to its
// end in turn, the CTAs in order (0), in reverse (1) or shuffled with
// `seed` (2), a CTA's threads in order.
extern "C" void h_grind(const lum::PowArgs* a, long long grid, int T, int order, unsigned seed) {
  std::vector<long long> ctas(grid);
  std::iota(ctas.begin(), ctas.end(), 0);
  if (order == 1) std::reverse(ctas.begin(), ctas.end());
  if (order == 2) {
    std::mt19937 rng(seed);
    std::shuffle(ctas.begin(), ctas.end(), rng);
  }
  for (long long c : ctas)
    for (int t = 0; t < T; t++) lum::pow_search(*a, (unsigned long long)(c * T + t), (unsigned long long)(grid * T));
}
"""


_CSRC = Path(kernels.__file__).resolve().parent / "csrc"


def _build(d: Path, header: str):
    """The shim over `header` (csrc/channel.cuh's text) with csrc/blake2s.cuh."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of csrc/channel.cuh")
    (d / "channel.cuh").write_text(header)
    (d / "blake2s.cuh").write_text((_CSRC / "blake2s.cuh").read_text())
    (d / "shim.cpp").write_text(_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(d), "-o", str(d / "ch.so"),
                    str(d / "shim.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "ch.so"))
    lib.h_channel_words.restype = lib.h_pow_args_size.restype = ctypes.c_longlong
    assert lib.h_channel_words() == kernels.CHANNEL_WORDS
    assert lib.h_pow_args_size() == ctypes.sizeof(kernels.PowArgs)
    lib.h_compress.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int]
    lib.h_take_words.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.h_pow_h01.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p]
    lib.h_pow_ok.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int]
    lib.h_grind.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_uint]
    return lib


@pytest.fixture(scope="module")
def host_channel(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("channel"), (_CSRC / "channel.cuh").read_text())


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("n_bytes", [0, 4, 40, 64, 68, 128, 200])
def test_host_blake2s_matches_hashlib(host_channel, n_bytes):
    msg = _u32(np.random.default_rng(n_bytes), n_bytes // 4)
    h = np.zeros(8, dtype=np.uint32)
    host_channel.h_init(_ptr(h))
    n_blocks = max(1, -(-n_bytes // 64))
    for b in range(n_blocks):
        block = np.zeros(16, dtype=np.uint32)
        part = msg[16 * b : 16 * b + 16]
        block[: len(part)] = part
        last = b == n_blocks - 1
        host_channel.h_compress(_ptr(h), _ptr(block), n_bytes if last else 64 * (b + 1), int(last))
    assert h.astype("<u4").tobytes() == hashlib.blake2s(msg.astype("<u4").tobytes()).digest()


def _take_spec(block, taken):
    """The reference host channel's rule (draw_base_felts): w < 2P kept as
    w mod P until four are taken; the rest of the block is dropped."""
    taken = list(taken)
    for w in block:
        if len(taken) == 4:
            break
        if int(w) < 2 * P:
            taken.append(int(w) % P)
    return taken


EDGES = [0x7FFFFFFE, 0x7FFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF]
CRAFTED = [
    EDGES + EDGES,
    [0xFFFFFFFF, 0xFFFFFFFE] * 4,
    [0xFFFFFFFE, 0x7FFFFFFF, 0xFFFFFFFF, 0x7FFFFFFE, 0, 1, 0xFFFFFFFF, 5],
    [0x7FFFFFFF, 0x7FFFFFFF, 0xFFFFFFFE, 0xFFFFFFFE, 0xFFFFFFFF, 0x7FFFFFFE, 0x80000000, 9],
]


@pytest.mark.parametrize("block", CRAFTED, ids=range(len(CRAFTED)))
@pytest.mark.parametrize("start", [0, 1, 3])
def test_word_acceptance_on_crafted_blocks(host_channel, block, start):
    """channel.cuh's take_words on words at and around P and 2P, from an
    empty and a part-filled draw: the reference's rule."""
    b = np.array(block, dtype=np.uint32)
    out = np.array([11, 22, 33, 44], dtype=np.uint32)
    n = host_channel.h_take_words(_ptr(b), _ptr(out), start)
    want = _take_spec(block, [11, 22, 33, 44][:start])
    assert n == len(want) and list(out[:n]) == want


def test_host_draws_match_twin_and_channel(host_channel):
    """channel.cuh's draw_felt and mix_root on hashlib-made digests: the
    host channel's words and the K8 twin's state."""
    for seed, counter in CASES[:16]:
        digest = np.frombuffer(hashlib.blake2s(bytes([seed])).digest(), dtype="<u4").copy()
        root = _u32(np.random.default_rng(seed), 8)
        state = np.zeros(kernels.CHANNEL_WORDS, dtype=np.uint32)
        state[:8], state[8] = digest, counter
        host_channel.h_draw_felt(_ptr(state))
        ch = _ref_channel(digest, counter)
        assert np.array_equal(state[9:], ch.draw_felt()) and state[8] == ch._counter
        host_channel.h_mix_root(_ptr(state), _ptr(root))
        host_channel.h_draw_felt(_ptr(state))
        ch.mix_root(root)
        assert np.array_equal(state[9:], ch.draw_felt()) and state[8] == ch._counter
        twin = kernels.channel_mix_root_draw_plain(_state(digest, counter).clone(), f.u32_to_tensor(root))
        plain = np.zeros(kernels.CHANNEL_WORDS, dtype=np.uint32)
        plain[:8], plain[8] = digest, counter
        host_channel.h_mix_root(_ptr(plain), _ptr(root))
        host_channel.h_draw_felt(_ptr(plain))
        assert np.array_equal(f.tensor_to_u32(twin), plain)


@pytest.mark.parametrize("bits", [0, 1, 5, 12, 31, 32, 33, 40, 64])
def test_host_pow_check_matches_channel(host_channel, bits):
    digest = _u32(np.random.default_rng(bits), 8)
    ch = Blake2sChannel()
    ch.digest = digest.astype("<u4").tobytes()
    for nonce in list(range(40)) + [2**32 - 1, 2**32, 2**40 + 3]:
        assert bool(host_channel.h_pow_ok(_ptr(digest), nonce, bits)) == ch.check_pow_nonce(bits, nonce)


@pytest.mark.parametrize("seed", range(6))
def test_host_search_hash_matches_hashlib(host_channel, seed):
    """The search's compression (pow_prefix, then pow_h01 per candidate):
    h[0] and h[1] are hashlib's first 8 bytes of H(digest || LE64(nonce)),
    nonces across the 32-bit boundary included."""
    rng = np.random.default_rng(500 + seed)
    digest = _u32(rng, 8)
    h = np.zeros(2, dtype=np.uint32)
    for nonce in [0, 1, 2**32 - 1, 2**32, 2**62 - 1] + [int(x) for x in rng.integers(0, 2**62, 20)]:
        host_channel.h_pow_h01(_ptr(digest), nonce, _ptr(h))
        want = hashlib.blake2s(digest.astype("<u4").tobytes() + nonce.to_bytes(8, "little")).digest()[:8]
        assert h.astype("<u4").tobytes() == want, nonce


def _host_search(lib, digest, bits, grid, threads, order, seed=0, parity=0):
    """kernels._pow_search through the host build: one launch of `grid`
    CTAs of `threads`, run in `order`, from a scratch whose other parity's
    word holds a stale value; returns (nonce, the scratch after)."""
    scratch = torch.tensor([-1, -1], dtype=torch.int64)
    scratch[1 - parity] = 12345

    def run(args):
        args.scratch, args.parity = scratch.data_ptr(), parity
        lib.h_grind(ctypes.addressof(args), grid, threads, order, seed)
        return int(scratch[parity])

    return kernels._pow_search(digest.astype("<u4").tobytes(), bits, run), scratch


# Round widths W = grid x threads of 1, 7 and 256; CTAs in order, reversed
# and shuffled: whatever order the CTAs run in, the least passing nonce, and
# the other parity's word put back to all ones for the next launch.
@pytest.mark.parametrize("order", [0, 1, 2], ids=["forward", "reversed", "shuffled"])
@pytest.mark.parametrize("grid,threads", [(1, 1), (7, 1), (8, 32)], ids=["W1", "W7", "W256"])
def test_host_grind_cta_orders(host_channel, order, grid, threads):
    for bits in range(13):
        digest = _u32(np.random.default_rng(700 + bits), 8)
        want = _ref_channel(digest, 0).grind_pow(bits)
        parity = bits & 1
        got, scratch = _host_search(host_channel, digest, bits, grid, threads, order, seed=bits, parity=parity)
        assert got == want, bits
        assert int(scratch[1 - parity]) == -1


def test_grind_none_below_limit_raises(host_channel, monkeypatch):
    """A search whose limit (kernels.pow_limit, patched to 40) lies below
    the least passing nonce finds none: the host build's result word stays
    all ones and the wrapper raises, and so does the twin."""
    digest = next(d for d in (_u32(np.random.default_rng(900 + s), 8) for s in range(100))
                  if _ref_channel(d, 0).grind_pow(10) > 40)
    with monkeypatch.context() as m:
        m.setattr(kernels, "pow_limit", lambda bits: 40)
        with pytest.raises(KernelError, match="no 10-bit nonce below 40"):
            _host_search(host_channel, digest, 10, 3, 4, 2)
        with pytest.raises(KernelError, match="no 10-bit nonce below 40"):
            kernels.grind_pow_plain(digest.astype("<u4").tobytes(), 10)
    got, _ = _host_search(host_channel, digest, 10, 3, 4, 2)
    assert got == _ref_channel(digest, 0).grind_pow(10)


# Mutations the order test must catch: a thread that stops once any nonce
# has passed (a smaller one may lie in a round it has not reached), and a
# launch that puts its own parity's word back, not the other.
@pytest.mark.parametrize("mutation", [
    ("if (pow_read(best) < start + W) break;", "if (pow_read(best) != ~0ull) break;"),
    ("if (mine == 0) a.scratch[1 - a.parity] = ~0ull;", "if (mine == 0) a.scratch[a.parity] = ~0ull;"),
])
def test_mutated_search_fails(tmp_path, mutation):
    old, new = mutation
    header = (_CSRC / "channel.cuh").read_text()
    assert header.count(old) == 1
    lib = _build(tmp_path, header.replace(old, new))
    wrong = 0
    for bits in range(4, 10):
        digest = _u32(np.random.default_rng(700 + bits), 8)
        for seed in range(3):
            try:
                got, scratch = _host_search(lib, digest, bits, 8, 32, 2, seed=seed)
            except KernelError:
                wrong += 1
                continue
            wrong += got != _ref_channel(digest, 0).grind_pow(bits) or int(scratch[1]) != -1
    assert wrong
