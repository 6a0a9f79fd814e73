"""Count the instructions of one Blake2s compression in SASS for sm_90a.

Compiles csrc/blake2s.cuh's `blake2s_compress` into two small kernels, one
that runs one compression and one that chains two, every input loaded
from memory, with the flags the port's kernels are built with, and
disassembles both with `cuobjdump -sass`.  The difference of the two
opcode counts is one compression with its per-block set-up (the counter
and flag words), free of the loads and stores around it.  It also counts the same
opcodes in K2's `merkle_pass_kernel` as `luminair_tpu_torch.kernels`
builds it, and in the same way (one candidate and two) the work of one
proof-of-work candidate of K10's search (csrc/channel.cuh `pow_h01`, from
the state `pow_prefix` leaves).  Last, the ALU instructions of
tools/blake2s_latency.cu's critical-path probe, whose loop body is one
compression's 240 dependent operations.

Run from the repository root on a machine with the CUDA toolkit:

    python3 tools/blake2s_sass_ops.py

It prints one JSON object: the opcodes of one compression, the ALU
instructions among them (`alu`), and `chip_smoke.OPS_BLAKE2S_BLOCK`, the
count the bounds use; the same for one candidate beside
`chip_smoke.OPS_POW_CANDIDATE`; the probe's.
"""

import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from luminair_tpu_torch import kernels  # noqa: E402

OUT = ROOT / "build" / "sass"

SOURCE = r"""
#include <stdint.h>
#include "blake2s.cuh"
#include "channel.cuh"

// in: h[8], then per compression its block m[16], byte counter and last flag.
template <int N>
__device__ void chain(const uint32_t* in, uint32_t* out) {
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] = in[i];
#pragma unroll
  for (int r = 0; r < N; r++) {
    const uint32_t* blk = in + 8 + 18 * r;
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 16; i++) m[i] = blk[i];
    lum::blake2s_compress(h, m, blk[16], blk[17] != 0);
  }
#pragma unroll
  for (int i = 0; i < 8; i++) out[i] = h[i];
}

extern "C" __global__ void one_compression(const uint32_t* in, uint32_t* out) { chain<1>(in, out); }
extern "C" __global__ void two_compressions(const uint32_t* in, uint32_t* out) { chain<2>(in, out); }

// in: the prefix state pre[16], the digest d[8], then N 64-bit nonces;
// out: h[0], h[1] of each candidate.
template <int N>
__device__ void candidates(const uint32_t* in, uint32_t* out) {
  uint32_t pre[16], d[8];
#pragma unroll
  for (int i = 0; i < 16; i++) pre[i] = in[i];
#pragma unroll
  for (int i = 0; i < 8; i++) d[i] = in[16 + i];
#pragma unroll
  for (int r = 0; r < N; r++) {
    const unsigned long long nonce = reinterpret_cast<const unsigned long long*>(in + 24)[r];
    lum::pow_h01(pre, d, nonce, out[2 * r], out[2 * r + 1]);
  }
}

extern "C" __global__ void one_candidate(const uint32_t* in, uint32_t* out) { candidates<1>(in, out); }
extern "C" __global__ void two_candidates(const uint32_t* in, uint32_t* out) { candidates<2>(in, out); }
"""

# Instruction lines of `cuobjdump -sass`: /*0090*/  @!P0 IADD3 R5, R2, R3, R4 ;
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)")
_FUNC = re.compile(r"Function : (\S+)")

# Integer ALU work; moves, memory, address and control instructions are not
# operations of the function.
ALU = {"IADD3", "LOP3", "SHF", "PRMT", "IMAD", "ISETP", "SEL", "IADD", "LEA", "IABS", "VIADD"}


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and Path(cand).exists():
            return cand
    raise SystemExit("cuobjdump not found: run this on a machine with the CUDA toolkit")


def opcodes(sass: str) -> dict:
    """{function: Counter of opcodes}; IMAD.MOV counts as a move (MOV)."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            op = m.group(1)
            cur["MOV" if op == "IMAD" and m.group(2).startswith(".MOV") else op] += 1
    return funcs


def alu(counts) -> int:
    return sum(n for op, n in counts.items() if op in ALU)


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    src, cubin = OUT / "blake2s_ops.cu", OUT / "blake2s_ops.cubin"
    src.write_text(SOURCE)
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")]
    subprocess.run([kernels._nvcc(), *flags, "-cubin", "-I", str(kernels._CSRC), "-o", str(cubin), str(src)],
                   check=True)
    funcs = opcodes(subprocess.run([_cuobjdump(), "-sass", str(cubin)], check=True, capture_output=True,
                                   text=True).stdout)
    def difference(one, two):
        d = collections.Counter(two)
        d.subtract(one)
        return {op: n for op, n in sorted(d.items()) if n}

    one = funcs["one_compression"]
    block = difference(one, funcs["two_compressions"])
    candidate = difference(funcs["one_candidate"], funcs["two_candidates"])
    probe = OUT / "blake2s_latency.cubin"
    subprocess.run([kernels._nvcc(), *flags, "-cubin", "-I", str(kernels._CSRC), "-o", str(probe),
                    str(ROOT / "tools" / "blake2s_latency.cu")], check=True)
    critical = next(c for name, c in opcodes(subprocess.run([_cuobjdump(), "-sass", str(probe)], check=True,
                                                            capture_output=True, text=True).stdout).items()
                    if "critical_path_kernel" in name)

    kernels.build()
    lib = kernels.MERKLE.library_path()
    merkle = {name: c for name, c in opcodes(subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True,
                                                            capture_output=True, text=True).stdout).items()
              if "merkle_pass_kernel" in name}
    import chip_smoke

    print(json.dumps({
        "compression_opcodes": block, "compression_alu": alu(block),
        "compression_all": sum(block.values()),
        "one_compression_kernel": dict(sorted(one.items())),
        "merkle_pass_kernel": {name: {"opcodes": dict(sorted(c.items())), "alu": alu(c)} for name, c in merkle.items()},
        "OPS_BLAKE2S_BLOCK": chip_smoke.OPS_BLAKE2S_BLOCK,
        "pow_candidate_opcodes": candidate, "pow_candidate_alu": alu(candidate),
        "OPS_POW_CANDIDATE": chip_smoke.OPS_POW_CANDIDATE,
        "critical_path_kernel_opcodes": dict(sorted(critical.items())), "critical_path_kernel_alu": alu(critical),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
