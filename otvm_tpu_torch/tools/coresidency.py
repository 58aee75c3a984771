"""Does the memory read's L2 merge survive SMs held by another stream?

    python -m otvm_tpu_torch.tools.coresidency [--other DIR] [--out FILE]

A read merged through L2 (`_cluster=1`) waits inside its launch at a
barrier of each output tile's blocks, so all its blocks must be on the card
at once.  The case: a helper kernel (csrc/sm_hold.cu) holds HELD SMs on a
second CUDA stream, one block an SM (200 KB of shared memory each leaves no
room for a block of the read), for HOLD_S seconds, past the barrier's trap
(2^32 cycles, ~2 s).  Once all its blocks are resident, the current stream
gets a forced L2 read at 512p in fp32 (HW 1024, T 6, 5 valid slots, 4
splits of 32 output tiles: 128 blocks, more than the SMs left).  The read
must finish within READ_TOL of the plain read.  A trap ends the process's
CUDA context, so the case runs in a child process: this checkout's
`otvm_tpu_torch`, and with `--other` also another checkout's (the parent
commit, unpacked with `git archive`), for which the helper is built from
this checkout's source.  A second child captures one such read in a CUDA
graph and replays it.  Prints one JSON line per child; exits 0 where this
checkout's read finished within tolerance.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HELD = 40                       # SMs the helper holds, one block each
HOLD_SMEM = 200 * 1024          # its shared memory a block
HOLD_S = 4.0                    # how long it holds them
READ = dict(hw=1024, t=6, count=5, splits=4)    # 512p, forced through L2
_THIS_ROOT = Path(__file__).resolve().parents[2]
_HOLD_SRC = _THIS_ROOT / "otvm_tpu_torch" / "kernels" / "csrc" / "sm_hold.cu"


def build_hold() -> Path:
    """The helper's library, built as the read's is (nvcc, into build/)."""
    from otvm_tpu_torch.kernels.memory_attn import compile_library

    return compile_library(_HOLD_SRC)[0]


def _inputs(torch):
    gen = torch.Generator(device="cuda").manual_seed(0)
    hw, t = READ["hw"], READ["t"]
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda")
               for shape in ((1, hw, 128), (1, t, hw, 128), (1, t, hw, 512)))
    return q, k, v, torch.arange(t, device="cuda")[None] < READ["count"]


def _forced(ma, q, k, v, mask):
    return ma.memory_read_cuda(q, k, v, mask, _splits=READ["splits"], _cluster=1)


def hold_child(hold_lib: str) -> dict:
    """The case, in this process, on the `otvm_tpu_torch` first on the path."""
    import torch

    from otvm_tpu_torch import set_fp32_numerics
    from otvm_tpu_torch.kernels import memory_attn as ma
    from otvm_tpu_torch.tools.kernel_check import READ_TOL, rel_err

    set_fp32_numerics()
    q, k, v, mask = _inputs(torch)
    want = ma.memory_read_plain(q, k, v, mask)
    _forced(ma, q, k, v, mask)          # build, cluster table, workspace: before the hold
    torch.cuda.synchronize()
    lib = ctypes.CDLL(hold_lib)
    lib.otvm_hold_sms.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_longlong, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.otvm_hold_sms.restype = ctypes.c_int
    side = torch.cuda.Stream()
    resident = ctypes.c_int(0)
    result = dict(package=os.path.dirname(os.path.dirname(os.path.abspath(ma.__file__))),
                  held=HELD, hold_s=HOLD_S,
                  read_blocks=-(-READ["hw"] // ma.query_tile(torch.float32)) * 2 *
                  READ["splits"],
                  card_blocks=ma.max_active_clusters(torch.float32, 128, 512)[1])
    t_hold = time.perf_counter()
    err = lib.otvm_hold_sms(HELD, HOLD_SMEM, int(HOLD_S * 1e9), int(10e9), side.cuda_stream,
                            ctypes.byref(resident))
    result.update(hold_error=err, held_resident=resident.value)
    if err != 0:
        return result
    t0 = time.perf_counter()
    result["hold_ran_s_before_read"] = t0 - t_hold
    stage = "launch"
    try:
        got = _forced(ma, q, k, v, mask)
        stage = "synchronize"
        torch.cuda.current_stream().synchronize()
        result["wait_s"] = time.perf_counter() - t0
        result["hold_running_at_read_end"] = not side.query()
        side.synchronize()
        rel = rel_err(got, want)
        result.update(finished=True, rel_err=rel, max_abs_err=(got - want).abs().max().item(),
                      tol=READ_TOL[torch.float32], ok=rel <= READ_TOL[torch.float32])
    except RuntimeError as e:
        result.update(finished=False, ok=False, failed_at=stage, error=str(e).splitlines()[0],
                      wait_s=time.perf_counter() - t0)
    return result


def graph_child() -> dict:
    """One forced L2 read captured in a CUDA graph (its workspace made on
    the capture stream before the capture), replayed, against the eager
    read's bits."""
    import torch

    from otvm_tpu_torch import set_fp32_numerics
    from otvm_tpu_torch.kernels import memory_attn as ma

    set_fp32_numerics()
    q, k, v, mask = _inputs(torch)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        eager = _forced(ma, q, k, v, mask)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with ma.record_launches() as reads, torch.cuda.graph(graph, stream=stream):
            out = _forced(ma, q, k, v, mask)
    except RuntimeError as e:
        return dict(captured=False, error=str(e).splitlines()[0])
    before = ma.launches
    graph.replay()
    ma.count_launches(reads)
    torch.cuda.synchronize()
    return dict(captured=True, replay_bit_identical=bool(torch.equal(out, eager)),
                recorded=reads, launches_counted_by_replay=ma.launches - before)


def run_child(root: Path, mode: str, hold_lib: Path = None, timeout: float = 120.0) -> dict:
    """A child process on `root`'s `otvm_tpu_torch` -> its JSON line, with
    its exit code and the tail of its errors."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", mode]
    if hold_lib is not None:
        cmd += ["--hold-lib", str(hold_lib)]
    proc = subprocess.run(cmd, env={**os.environ, "PYTHONPATH": str(root)}, cwd=str(root),
                          capture_output=True, text=True, timeout=timeout)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    out = json.loads(lines[-1]) if lines else {}
    out.update(root=str(root), rc=proc.returncode,
               stderr_tail=proc.stderr.strip().splitlines()[-3:])
    return out


def run_case(root: Path = _THIS_ROOT) -> dict:
    """The held-SM case on `root`'s read, the helper built from this checkout."""
    return run_child(Path(root), "hold", build_hold())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", default=None, help="root of another checkout to run the case on")
    ap.add_argument("--out", default=None, help="also write the results to this JSON file")
    ap.add_argument("--hold-lib", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--child", choices=("hold", "graph"), default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child == "hold":
        print(json.dumps(hold_child(args.hold_lib)), flush=True)
        return 0
    if args.child == "graph":
        print(json.dumps(graph_child()), flush=True)
        return 0
    sys.path.insert(0, str(_THIS_ROOT))
    results = {"this": run_case(_THIS_ROOT),
               "graph": run_child(_THIS_ROOT, "graph")}
    if args.other:
        results["other"] = run_case(Path(args.other).resolve())
    for name, res in results.items():
        print(f"{name}: {json.dumps(res)}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if results["this"].get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
