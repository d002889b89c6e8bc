"""Phase timestamps of the decode MLP's two launches on the card.

Builds a copy of `embodied_captioning_tpu_torch/kernels/csrc/decode_mlp.cu`
in which each `// mark N: phase` line of `mlp_wg_kernel` becomes a store of
%globaltimer by thread 0 of every block into a device buffer, runs it at
the serving shape (64 rows, 768 -> 3072 -> 768, int8 weights, `mlp_plan`'s
splits) and prints, for each launch and mark, the minimum, mean and maximum
over the blocks in microseconds from the first block's start, then the
instrumented build's time per call with the marks off, from CUDA events
over back-to-back calls. A mark costs a load and a store; the phases' lengths, not the
total, are the reading.

    python3 scripts/trace_decode_mlp.py      # one card, nvcc on PATH or
                                             # under CUDA_HOME
    python3 scripts/trace_decode_mlp.py --splits 8 8   # other splits
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from embodied_captioning_tpu_torch.kernels import _lib  # noqa: E402
from embodied_captioning_tpu_torch.kernels import decode_attention as DA  # noqa: E402
from embodied_captioning_tpu_torch.models import quantize as QZ  # noqa: E402

SOURCE = ROOT / "embodied_captioning_tpu_torch/kernels/csrc/decode_mlp.cu"
SLOTS = 12  # marks a block
# a phase boundary in the kernel: `// mark N: what has happened`
MARK = re.compile(r"^( *)// mark (\d+): (.+)$", re.M)
PRELUDE = """
__device__ unsigned long long* g_trace;
#define TR(i) do { if (threadIdx.x == 0 && g_trace) { \\
  unsigned long long t_; \\
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_)); \\
  const int b_ = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * \\
                                           blockIdx.z); \\
  g_trace[((kFc ? 0 : 1) * 1024 + b_) * SLOTS + (i)] = t_; } } while (0)
"""


def phases(src: str) -> dict:
    """{mark: phase} of the kernel's `// mark N:` lines; a mark may stand
    on two paths (fc's and proj's), under one name."""
    out = {}
    for _, n, text in MARK.findall(src):
        if out.setdefault(int(n), text) != text:
            raise SystemExit(f"trace_decode_mlp: mark {n} has two names")
    if not out or sorted(out) != list(range(len(out))) or len(out) > SLOTS:
        raise SystemExit(f"trace_decode_mlp: marks {sorted(out)} are not "
                         f"0, 1, ... (at most {SLOTS})")
    return out


def instrumented_source() -> str:
    """The kernel source with thread 0 of every block storing the time at
    each mark."""
    src = SOURCE.read_text()
    phases(src)
    head = "namespace {\n"
    if head not in src:
        raise SystemExit("trace_decode_mlp: no anonymous namespace in the "
                         "kernel source")
    src = src.replace(head, PRELUDE.replace("SLOTS", str(SLOTS)) + head, 1)
    src = MARK.sub(lambda m: f"{m.group(1)}TR({m.group(2)});", src)
    return src + ('\nextern "C" int ecap_set_trace(void* p) {\n'
                  '  return (int)cudaMemcpyToSymbol(g_trace, &p, '
                  'sizeof(p));\n}\n')


def build(tmp: Path) -> ctypes.CDLL:
    cu, so = tmp / "decode_mlp_trace.cu", tmp / "decode_mlp_trace.so"
    cu.write_text(instrumented_source())
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS[:6], "-shared", "-I",
                    str(SOURCE.parent), str(cu), "-o", str(so)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.ecap_decode_mlp.argtypes = _lib._SIGNATURES["ecap_decode_mlp"]
    lib.ecap_set_trace.argtypes = [ctypes.c_void_p]
    return lib


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", type=int, nargs=2, metavar=("FC", "PROJ"),
                    help="the two products' splits (default: mlp_plan's)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_decode_mlp: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    b, d, f = 64, 768, 3072
    wfc = QZ.quantize_array(rn(d, f, scale=d ** -0.5, dtype=torch.float32))
    wpj = QZ.quantize_array(rn(f, d, scale=f ** -0.5, dtype=torch.float32))
    x = rn(b, d)
    args = (x, 1.0 + rn(d, scale=0.1, dtype=torch.float32),
            rn(d, scale=0.1, dtype=torch.float32), wfc.q, wfc.scale,
            rn(f, scale=0.02, dtype=torch.float32), wpj.q, wpj.scale,
            rn(d, scale=0.02, dtype=torch.float32))
    h = torch.empty(b, f, dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    s_fc, s_pj = opts.splits or DA.mlp_plan(b, d, f)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))

        def call():
            err = lib.ecap_decode_mlp(
                *(t.data_ptr() for t in args), h.data_ptr(), out.data_ptr(),
                b, d, f, 1e-5, 1, s_fc, s_pj, _lib.current_stream())
            if err:
                raise RuntimeError(f"ecap_decode_mlp: CUDA error {err}")

        want = DA.decode_mlp_plain(*args)
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        trace = torch.zeros(2 * 1024 * SLOTS, dtype=torch.int64, device=dev)
        lib.ecap_set_trace(ctypes.c_void_p(trace.data_ptr()))
        runs = []
        for _ in range(3):
            trace.zero_()
            torch.cuda._sleep(200_000_000)  # clocks up, queue ahead
            call()
            torch.cuda.synchronize()
            runs.append(trace.view(2, 1024, SLOTS).cpu())
        lib.ecap_set_trace(ctypes.c_void_p(0))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(200):
            call()
        end.record()
        torch.cuda.synchronize()
        us = start.elapsed_time(end) * 1e3 / 200
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    blocks = {"fc": -(-f // 128) * s_fc, "proj": -(-d // 64) * s_pj}
    result = {"card": smi, "splits": [s_fc, s_pj], "max_abs_err": err,
              "events_us": us, "marks": {}}
    t = runs[-1]
    t0 = min(int(t[k, :n, 0][t[k, :n, 0] > 0].min())
             for k, n in enumerate(blocks.values()))
    for k, (name, n) in enumerate(blocks.items()):
        print(f"{name}: {n} blocks")
        rows = []
        for i, phase in sorted(phases(SOURCE.read_text()).items()):
            col = t[k, :n, i]
            col = col[col > 0].double() - t0
            if not len(col):
                continue
            rows.append(dict(mark=i, phase=phase, min=col.min().item() / 1e3,
                             mean=col.mean().item() / 1e3,
                             max=col.max().item() / 1e3))
            print(f"  {i:2d} {phase:30s} min {rows[-1]['min']:7.2f}  mean "
                  f"{rows[-1]['mean']:7.2f}  max {rows[-1]['max']:7.2f} us")
        result["marks"][name] = rows
    print(f"max_abs_err against the plain version {err:.3e}; marks off "
          f"{us:.2f} us a call (CUDA events, 200 calls)")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
