"""What each design choice of the trace segment kernel is worth on the card.

Builds csrc/ as it is and in variants that each undo one choice of
csrc/trace.cu / trace.cuh (in copies under build/variants/), runs the
black-scholes PINN's settings pass and trace (batch 256, chip_smoke.py's
graph) once through each, keeps every segment they launched, and times
each segment alone from fresh outputs under torch.profiler: its device time
per launch, the mean of 5.  The build as it is runs first and again last
(the drift between the two is the yardstick's noise), and also with other
tile limits (kernels.SEG_MAX_TILES).  Variants:

    plain_stores     column words stored with plain stores, not streaming
    mod_to_m31       to_m31 as a 64-bit `%` (a call to the division routine)
    poll_32ns        the grid barrier polls every 32 ns, not 256
    grid_2_per_sm    at most 2 CTAs an SM, not as many as fit
    l2_reads         every source read through L2, not the read-only cache

Run from the repository root on a machine with one CUDA card:

    python3 tools/trace_segment_variants.py

It prints the card's name and power limit, then one JSON line per build
and tile limit: each segment's device ms (the settings pass's six, then
the trace's four) and their sums.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from luminair_tpu_torch import kernels  # noqa: E402
from luminair_tpu_torch import prelude as T  # noqa: E402
from luminair_tpu_torch.models import black_scholes as BS  # noqa: E402

CSRC = ROOT / "luminair_tpu_torch" / "csrc"
VARIANTS = {
    "plain_stores": ("trace.cuh", "__stcs((unsigned int*)p, v);", "*p = v;"),
    "mod_to_m31": ("trace.cuh", "const unsigned long long u = (unsigned long long)v ^ (1ull << 63);",
                   "long long m = v % M31_P; return (uint32_t)(m < 0 ? m + M31_P : m);\n"
                   "  const unsigned long long u = (unsigned long long)v ^ (1ull << 63);"),
    "poll_32ns": ("trace.cu", "__nanosleep(256)", "__nanosleep(32)"),
    "grid_2_per_sm": ("trace.cu", "fit[dev] = (long long)per_sm * sms;",
                      "fit[dev] = (long long)(per_sm < 2 ? per_sm : 2) * sms;"),
    "l2_reads": ("trace.cuh", "return fresh ? __ldcg(p) : __ldg(p);", "return __ldcg(p);"),
}


def use(csrc: Path, build: Path) -> None:
    kernels._CSRC, kernels.BUILD_DIR = csrc, build
    for k in kernels.KERNELS:
        k._fns = None
    kernels.load_all()


def device_ms(run, n: int = 5) -> float:
    """Device time of one launch of trace_segment_kernel by `run`: the
    profiled time over the launches the profiler recorded."""
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total", 0), e.count) for e in prof.key_averages()
            if "trace_segment_kernel" in e.key]
    count = sum(c for _, c in rows)
    return sum(us for us, _ in rows) / 1e3 / count if count else float("nan")


def segments() -> list:
    """Every segment of the PINN's settings pass and trace, in launch order."""
    kept, launch = [], kernels.trace_segment

    def keep(seg):
        kept.append(seg)
        return launch(seg)

    kernels.trace_segment = keep
    try:
        cx, _ = chip_smoke.pinn_graph(T, BS)
        T.gen_trace(cx, T.gen_circuit_settings(cx))
    finally:
        kernels.trace_segment = launch
    return kept


def main() -> int:
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    builds = {"as_built": CSRC}
    for name, (source, old, new) in VARIANTS.items():
        copy = ROOT / "build" / "variants" / name / "csrc"
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(CSRC, copy)
        text = (copy / source).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} is not in {source} once")
        (copy / source).write_text(text.replace(old, new))
        builds[name] = copy
    builds["as_built_again"] = CSRC
    limit = kernels.SEG_MAX_TILES
    for name, csrc in builds.items():
        use(csrc, ROOT / "build" / "variants" / name.replace("_again", "") / "kernels")
        segs = segments()
        for tiles in ((limit, 4096, 1024) if name == "as_built" else (limit,)):
            kernels.SEG_MAX_TILES = tiles
            ms = [device_ms(lambda f=seg.fresh(): kernels.trace_segment(f)) for seg in segs]
            n_settings = sum(not seg.has_columns for seg in segs)
            print(json.dumps({"build": name, "card": card, "seg_max_tiles": tiles, "device_ms": ms,
                              "settings_ms": sum(ms[:n_settings]), "trace_ms": sum(ms[n_settings:])}), flush=True)
        kernels.SEG_MAX_TILES = limit
    return 0


if __name__ == "__main__":
    sys.exit(main())
