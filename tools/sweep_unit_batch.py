"""Sweep unit_batch for the device engine on the GPU.

Maps the 10k SE golden set once per size (after a warmup run to absorb
the compile) and prints reads/s + md5 check per size.
"""

import hashlib
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_SAM_BODY = None


def body_md5(path):
    h = hashlib.md5()
    with open(path, "rb") as f:
        for line in f:
            if not line.startswith(b"@"):
                h.update(line)
    return h.hexdigest()


def main():
    import __graft_entry__ as g
    from abismal_tpu.map.engine import run_map
    from abismal_tpu.map.pipeline import make_tpu_native_engine_factory

    index = g._tiny_index()
    d = tempfile.mkdtemp(prefix="abismal_sweep_")
    import gzip
    fq = os.path.join(d, "r_1.fq")
    with open(fq, "wb") as f:
        f.write(gzip.open(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tests", "golden", "reads_1.fq.gz")).read())
    sam = os.path.join(d, "out.sam")
    threads = os.cpu_count() or 1

    sizes = [int(s) for s in (sys.argv[1:] or ["2048", "8192", "16384"])]
    ref = None
    for ub in sizes:
        factory = make_tpu_native_engine_factory(unit_batch=ub,
                                                 n_threads=threads)
        run_map(index, fq, None, sam, None, "bench", engine_factory=factory,
                threads=threads)  # warmup/compile
        t0 = time.perf_counter()
        run_map(index, fq, None, sam, None, "bench", engine_factory=factory,
                threads=threads)
        dt = time.perf_counter() - t0
        m = body_md5(sam)
        if ref is None:
            ref = m
        print(f"unit_batch={ub:6d}  {10000/dt:9.1f} reads/s  "
              f"md5={'OK' if m == ref else 'MISMATCH ' + m}", flush=True)


if __name__ == "__main__":
    main()
