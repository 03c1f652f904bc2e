"""Where K6's time goes on the card: the phases of one launch.

    python3 benchmarks/torch_k6_phases.py [--shapes 16x30016 48x30016]
                                          [--blocks-per-sm 4 6 8]

Builds an instrumented copy of `src/repro_torch/kernels/csrc/
prefix_sum.cu` into `build/k6_phases/`: thread 0 of every block stamps
the card's global timer when the block starts, before and after the
grid barrier, and when it ends. For each shape (rows x row length) and
each co-resident block cap (`MAX_BLOCKS_PER_SM`; default the source's
own), it checks the result against `prefix_sum_ref` bit for bit and
prints the device ms a call (CUDA events after a held stream, as
`chip_smoke.cuda_ms`), the blocks launched, and the microseconds from
the first block's start to the last block's end of phase A, exit from
the barrier and end of phase B. The timer moves in steps of about
0.26 us. The stamps cost a few stores a block, so the instrumented ms
run a little above the shipped kernel's (`chip_smoke.py` phase 20).
Exits 1 without a CUDA device or when a result differs.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from chip_smoke import cuda_ms, prefix_rows  # noqa: E402

STAMP = ("  auto stamp = [&](int k) {\n"
         "    if (threadIdx.x == 0) {\n"
         "      unsigned long long t;\n"
         "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "      st[blockIdx.x * 4 + k] = t;\n"
         "    }\n"
         "  };\n")


def instrumented(src: str, per_sm: int) -> str:
    """The kernel's source with the four stamps, a stamp buffer argument
    and `per_sm` co-resident blocks an SM."""
    edits = [
        ("int vec) {", "int vec, unsigned long long* st) {\n" + STAMP +
         "  stamp(0);"),
        ("  cg::this_grid().sync();\n",
         "  stamp(1);\n  cg::this_grid().sync();\n  stamp(2);\n"),
        ("    if (c == 0 && tid == 0) orow[0] = 0.0f;\n  }\n}",
         "    if (c == 0 && tid == 0) orow[0] = 0.0f;\n  }\n"
         "  __syncthreads();\n  stamp(3);\n}"),
        ("int R, long long F, void* stream) {",
         "int R, long long F, void* stream, unsigned long long* st) {"),
        ("(void*)&F, (void*)&L, (void*)&vec};",
         "(void*)&F, (void*)&L, (void*)&vec, (void*)&st};"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"torch_k6_phases: the kernel's source no "
                             f"longer has one {old!r}")
        src = src.replace(old, new)
    return re.sub(r"MAX_BLOCKS_PER_SM = \d+",
                  f"MAX_BLOCKS_PER_SM = {per_sm}", src)


def build_variant(per_sm: int):
    from repro_torch.kernels import build

    src = (build.CSRC / "prefix_sum.cu").read_text()
    out_dir = ROOT / "build" / "k6_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"prefix_sum_{per_sm}.cu"
    so = out_dir / f"libprefix_sum_{per_sm}.so"
    cu.write_text(instrumented(src, per_sm))
    res = subprocess.run(
        [build.nvcc_path(), *build.ARCH, *build.BASE_FLAGS, "-Xptxas", "-v",
         "-I", str(build.CSRC), "-o", str(so), str(cu)],
        capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"{per_sm} blocks an SM: {line.strip()}")
    lib = ctypes.CDLL(str(so))
    lib.saath_prefix_sum.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.saath_prefix_sum.restype = ctypes.c_int
    lib.saath_prefix_sum_scratch.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.saath_prefix_sum_scratch.restype = ctypes.c_longlong
    return lib


def measure(lib, R: int, F: int) -> str:
    import torch

    from repro_torch.kernels.ref import prefix_sum_ref

    x = prefix_rows(R, F, F, torch.device("cuda"))
    want = prefix_sum_ref(x)
    out = torch.empty((R, F + 1), device=x.device)
    scratch = torch.empty(max(lib.saath_prefix_sum_scratch(R, F), 1),
                          device=x.device)
    stamps = torch.zeros(4 * R * (-(-F // 4096)), dtype=torch.int64,
                         device=x.device)

    def call():
        err = lib.saath_prefix_sum(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(), R, F,
            torch.cuda.current_stream().cuda_stream, stamps.data_ptr())
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")

    call()
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
        print(f"({R}, {F}): differs from prefix_sum_ref", flush=True)
        raise SystemExit(1)
    ms = cuda_ms(call, 200)
    stamps.zero_()
    call()
    torch.cuda.synchronize()
    st = stamps.view(-1, 4).cpu()
    st = st[st[:, 0] > 0].double()
    t0 = st[:, 0].min()

    def last(k):
        return float(st[:, k].max() - t0) / 1e3

    return (f"({R}, {F}): {ms:.4f} ms a call, {st.shape[0]} blocks; from "
            f"the first start: phase A ends {last(1):.2f} us, the barrier "
            f"{last(2):.2f} us, phase B {last(3):.2f} us")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", nargs="+",
                    default=["16x30016", "48x30016", "80x30016"])
    ap.add_argument("--blocks-per-sm", nargs="+", type=int)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k6_phases: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    src = (build.CSRC / "prefix_sum.cu").read_text()
    own = int(re.search(r"MAX_BLOCKS_PER_SM = (\d+)", src).group(1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for per_sm in args.blocks_per_sm or [own]:
        lib = build_variant(per_sm)
        for shape in args.shapes:
            R, F = (int(v) for v in shape.split("x"))
            print(f"{per_sm} blocks an SM, {measure(lib, R, F)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
