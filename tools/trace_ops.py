"""Device-time reduction of a jax.profiler trace, and a per-op table for
the fused stage-1+2 program.

`device_times(trace_dir)` reads the newest `.xplane.pb` under trace_dir
with jax.profiler.ProfileData and returns, for the GPU planes
(`/device:GPU:*`), the summed kernel time per op name, the busy time (the
union of kernel intervals) and the window (first start to last end).
Kernel events are taken from the planes' stream lines; the "XLA Ops" and
"XLA Modules" lines repeat them at coarser grain and are skipped.

Usage (per-op table of the SE fused program on a tRex1 workload):
  python tools/trace_ops.py [unit_batch] [reps] [top_n]
"""

import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_times(trace_dir: str) -> dict:
    """{"ops": {name: ns}, "busy_ns", "window_ns", "lines": [...]} for the
    GPU planes of the newest trace under trace_dir."""
    from jax.profiler import ProfileData

    files = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(max(files, key=os.path.getmtime))
    ops, spans, lines = {}, [], []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            lines.append(f"{plane.name}/{line.name}")
            if line.name in ("XLA Ops", "XLA Modules") or \
                    "Stream" not in line.name:
                continue
            for ev in line.events:
                ops[ev.name] = ops.get(ev.name, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy = 0.0
    end = None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (max(e for _, e in spans) - min(s for s, _ in spans)
              if spans else 0.0)
    return {"ops": ops, "busy_ns": busy, "window_ns": window,
            "lines": sorted(set(lines))}


def fusions_with(hlo_text: str, needle: str) -> dict:
    """{fusion instruction name: sorted op kinds of its fused computation}
    for every fusion whose computation contains `needle` (an HLO opcode,
    e.g. "popcnt"): shows which kernel an op landed in, and what else was
    fused with it."""
    import re

    comps, cur, body = {}, None, []
    for line in hlo_text.splitlines():
        m = re.match(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if m and "=" not in line.split("{")[0]:
            cur, body = m.group(1), []
            comps[cur] = body
        elif cur is not None:
            body.append(line)
    out = {}
    for lines in comps.values():
        for line in lines:
            m = re.search(r"%([\w.\-]+) = .*? fusion\(.*calls=%?([\w.\-]+)",
                          line)
            if not m or m.group(2) not in comps:
                continue
            ops = set()
            for inner in comps[m.group(2)]:
                k = re.search(r"= \S+ ([a-z\-]+)\(", inner)
                if k:
                    ops.add(k.group(1))
            if needle in ops:
                out[m.group(1)] = sorted(ops)
    return out


def stage12_inputs(eng, unit_batch: int):
    """One SE chunk of simulated tRex1 reads laid out for build_stage12
    (the engine's own dense layout); also sets eng's candidate budget.
    Returns (per, (pnib, lens, is_ga, scode, max_diffs_r))."""
    import tempfile

    import numpy as np

    from abismal_tpu.io.fastq import ReadLoader
    from abismal_tpu.map.pipeline import get_conv_is_ga
    from abismal_tpu.sim.simreads import SimConfig, simulate_reads

    genome = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "data", "tRex1.fa")
    d = tempfile.mkdtemp(prefix="abismal_chunk_")
    simulate_reads(genome, SimConfig(
        output_prefix=os.path.join(d, "r"), n_reads=unit_batch // 2,
        mutation_rate=0.01, bs_conv=0.98, seed=1, single_end=True))
    reads = ReadLoader(os.path.join(d, "r_1.fq"),
                       batch_size=unit_batch // 2).load_batch()
    pnib, lens, per, _ = eng._se_units_mat(reads, False, False)
    scode = eng._se_scode_pattern(False, False)
    is_ga_pat = np.array([get_conv_is_ga(int(c)) for c in scode], dtype=bool)
    B = unit_batch - (unit_batch % per)
    pad = B - pnib.shape[0]
    if pad > 0:
        pnib = np.pad(pnib, ((0, pad), (0, 0)))
        lens = np.pad(lens, (0, pad))
    rpc = B // per
    max_diffs_r = (0.1 * lens.reshape(rpc, per).max(axis=1)
                   .astype(np.float64)).astype(np.int32)
    eng._budget_for((pnib, lens), is_ga_pat, per)
    return per, (pnib[:B], lens[:B], np.tile(is_ga_pat, rpc), scode,
                 max_diffs_r)


def main():
    import numpy as np

    import jax

    import __graft_entry__ as g
    from abismal_tpu.map.pipeline import (
        TpuNativeEngine, build_stage12, interpret_kernels,
    )

    unit_batch = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    top_n = int(sys.argv[3]) if len(sys.argv) > 3 else 40

    index = g._tiny_index()
    eng = TpuNativeEngine(index, lmax=128, unit_batch=unit_batch,
                          n_threads=1)
    per, args_np = stage12_inputs(eng, unit_batch)
    tables = eng.dev.tables()
    args = tuple(jax.device_put(a) for a in args_np)
    prog, _ = build_stage12(eng.lmax, eng.dev.max_candidates,
                            eng.dev.n_index2, eng.dev.n_index3, per,
                            cand_per_unit=eng.cand_budget,
                            interpret=interpret_kernels(),
                            ext_iters=eng.dev.ext_iters)
    t0 = time.perf_counter()
    np.asarray(prog(*tables, *args))
    print(f"first exec (compile): {time.perf_counter()-t0:.1f}s", flush=True)

    td = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".smoke", "trace_stage12")
    with jax.profiler.trace(td):
        for _ in range(reps):
            out = prog(*tables, *args)
        np.asarray(out)
    t = device_times(td)
    total = sum(t["ops"].values())
    print(f"device busy {t['busy_ns'] / 1e6 / reps:.3f} ms/exec of a "
          f"{t['window_ns'] / 1e6 / reps:.3f} ms/exec window "
          f"({reps} execs); lines: {t['lines']}")
    print(f"{'us/exec':>12}  {'pct':>5}  op")
    for name, dur in sorted(t["ops"].items(), key=lambda kv: -kv[1])[:top_n]:
        print(f"{dur / 1e3 / reps:12.1f}  {100 * dur / max(total, 1):5.1f}  "
              f"{name[:90]}")
    hlo = prog.lower(*tables, *args).compile().as_text()
    for name, ops in fusions_with(hlo, "popcnt").items():
        # the trace names a fusion's kernel with '_' where HLO has '.'
        ns = t["ops"].get(name.replace(".", "_"), 0.0)
        print(f"popcnt fusion {name}: {ns / 1e3 / reps:.1f} us/exec; "
              f"fused ops {ops}")


if __name__ == "__main__":
    main()
