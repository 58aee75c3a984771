"""Where a stream cell's runs differ: runs the cell as separate
benchmark/run.py processes, as a check does, with the same seeds in turns
over one or more trees (a checkout of this harness, an older one), and
collects each run's result and the notes it prints on standard error (each
window clip's fps):

    python3 benchmark/spread.py --workload s4-stream-1088x1920-bf16 \\
        --seeds 11,12,13,14,15,16 --seconds 30 --tree . --tree <older checkout> \\
        [--spans] [--out spread.jsonl]

With --spans each run goes through a small wrapper in its own process,
which turns the port's spans on (`trace.enable()`, ~2 us a span) and
prints, for each clip the runner serves (the first is the warm-up), its
spans in ms a frame and the process's user and system seconds: such runs
are for diagnosis, not the cell's.  One JSON line a run goes to --out; a
line a run, and each tree's median and quartile spread of each end-to-end
metric, to standard output."""
import argparse
import json
import os
import resource
import runpy
import statistics
import subprocess
import sys
import time

SPANS = ("serve.prepare", "serve.upload", "serve.step", "serve.readback_wait", "serve.outputs",
         "serve.prefetch")
CLIP_SPANS = "clip spans: "


def _span_summary(records, frames):
    """ms a frame by span name, and the host frame (serve.frame less its
    readback wait) a frame: median and 90th percentile."""
    by = {}
    for r in records:
        if r.kind == "span":
            by.setdefault(r.name, []).append(r)
    out = {name: sum(r.ms for r in by.get(name, [])) / frames for name in SPANS}
    wait = {r.parent: r.ms for r in by.get("serve.readback_wait", [])}
    host = sorted(r.ms - wait.get(r.id, 0.0) for r in by.get("serve.frame", []))
    if host:
        out["host_frame_med"] = statistics.median(host)
        out["host_frame_p90"] = host[min(len(host) - 1, int(0.9 * len(host)))]
    return out


def child(argv):
    """Runs ./benchmark/run.py with `argv` in this process, the port's spans
    on, and prints each served clip's spans on standard error."""
    g = runpy.run_path(os.path.join("benchmark", "run.py"), run_name="spread_child")
    from benchmark.runners import stream
    from otvm_tpu_torch.utils import trace

    serve = stream._serve
    trace.enable()

    def timed(ev, joint, frames, tri):
        trace.take()
        a, t = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter()
        out = serve(ev, joint, frames, tri)
        b, s = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter() - t
        row = {"frames": len(frames), "fps": len(frames) / s, "user_s": b.ru_utime - a.ru_utime,
               "sys_s": b.ru_stime - a.ru_stime, **_span_summary(trace.take(), len(frames))}
        print(CLIP_SPANS + json.dumps(row), file=sys.stderr, flush=True)
        return out

    stream._serve = timed
    return g["main"](argv, g["ROOT"], g["T_IMPORT"])


def spread(values):
    """The quartiles' distance over the median (statistics.quantiles)."""
    if len(values) < 2:
        return None
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def run_one(tree, workload, seed, seconds, trace, spans, timeout):
    args = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    cmd = ([sys.executable, os.path.abspath(__file__), "--child", "--"] if spans
           else [sys.executable, os.path.join("benchmark", "run.py")]) + args
    t0 = time.time()
    try:
        p = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=timeout)
        rc, stdout, stderr = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        text = lambda b: b.decode(errors="replace") if isinstance(b, bytes) else b or ""
        rc, stdout, stderr = 124, text(e.stdout), text(e.stderr)
    row = {"tree": tree, "seed": seed, "rc": rc, "wall_s": time.time() - t0, "spans": spans}
    lines = [l for l in stdout.splitlines() if l.startswith("{")]
    if lines:
        res = json.loads(lines[-1])
        row.update(correct=res["correct"],
                   metrics={k: v["value"] for k, v in res["metrics"].items()},
                   compared={k: v["value"] for k, v in res.get("compared", {}).items()},
                   peak=res["device"]["memory_peak_bytes"])
    err = stderr.splitlines()
    fps = [l for l in err if l.startswith("clip fps: ")]
    row["clip_fps"] = [float(x) for x in fps[-1].split()[2:]] if fps else []
    row["clips"] = [json.loads(l[len(CLIP_SPANS):]) for l in err if l.startswith(CLIP_SPANS)]
    row["stderr_tail"] = stderr[-1500:] if rc or not lines else "\n".join(
        l for l in err if l.startswith("setup "))
    return row


def _show(row):
    s = (f"{os.path.basename(row['tree'])} seed {row['seed']} rc {row['rc']} correct "
         f"{row.get('correct')} {row.get('metrics')} | clips "
         + " ".join(f"{f:.3f}" for f in row["clip_fps"]))
    if row["clips"]:
        s += " | spans " + json.dumps([{k: round(v, 2) for k, v in c.items()}
                                       for c in row["clips"]])
    return s


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout to run, in turns with the others")
    ap.add_argument("--spans", action="store_true", help="the port's spans on (diagnosis only)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=600)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    trees = [os.path.abspath(t) for t in args.tree]
    print(json.dumps({"card": _card(), "cpus": os.cpu_count()}), flush=True)
    rows = []
    for i, seed in enumerate(seeds):
        for tree in (trees if i % 2 == 0 else trees[::-1]):
            row = run_one(tree, args.workload, seed, args.seconds, args.trace, args.spans,
                          args.timeout)
            rows.append(row)
            print(_show(row), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    for tree in trees:
        done = [r["metrics"] for r in rows if r["tree"] == tree and "metrics" in r]
        for metric in sorted({k for m in done for k in m}):
            vals = [m[metric] for m in done if metric in m]
            print(f"{tree} {metric}: median {statistics.median(vals)!r} spread "
                  f"{spread(vals)!r} of {len(vals)}: {vals}", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:3] == ["--child", "--"]:
        sys.exit(child(sys.argv[3:]))
    sys.exit(main(sys.argv[1:]))
