"""Parity of the compiled GPU code: the Triton banded kernels and the fused
stage-1+2 programs, compiled for the card (no interpret mode).  Every test
here takes the `gpu` fixture and skips without a GPU; run them on the card
with

    ABISMAL_TEST_DEVICE=gpu python -m pytest -m gpu tests/
"""

import gzip
import os

import numpy as np
import pytest

from tests.conftest import GOLDEN, golden_path


@pytest.mark.gpu
def test_compiled_banded_kernels_match_host(gpu, trex1_index):
    from abismal_tpu.kernels.banded_align import (
        build_banded_scorer, build_banded_tracer, prepare_jobs,
    )
    from abismal_tpu.map.align import BandedAligner
    from abismal_tpu.map.pipeline import build_tb_block
    from abismal_tpu.map.seeds import SeedIndexView
    from chip_smoke import assemble_cigar, mutated_jobs

    nib = SeedIndexView(trex1_index).nib
    jobs = mutated_jobs(nib, 1024, seed=13)
    aln = BandedAligner(nib, use_native=True)
    aln.reset(128)
    want, cigars = [], []
    for q, d, md, p in jobs:
        want.append(aln.align(d, md, q, p, True))
        cigars.append(aln.build_cigar_len_and_pos(d, md, p))
    q, win, bw, qsz, _ = prepare_jobs(nib, jobs, 128)
    got = np.asarray(build_banded_scorer(128)(q, win, bw, qsz))[:, 0]
    np.testing.assert_array_equal(got[: len(jobs)], np.array(want))

    pos = np.array([p for *_, p in jobs], dtype=np.uint32)
    ops, meta = (np.asarray(a) for a in build_tb_block(128)(
        q, win, bw[:, 0], qsz[:, 0], pos, np.ones(len(jobs), bool)))
    n = 0
    for i, (qq, *_r) in enumerate(jobs):
        c = assemble_cigar(ops[i], meta[i], qq.shape[0])
        if want[i] > 0 and c is not None:
            assert c == (cigars[i][0], cigars[i][1],
                         cigars[i][2] % (1 << 32)), i
            n += 1
    assert n > len(jobs) // 2
    tri = build_banded_tracer(128)(q, win, bw, qsz)
    xla = build_banded_tracer(128, impl="xla")(q, win, bw, qsz)
    for a, b in zip(tri, xla):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.gpu
@pytest.mark.parametrize("prefix,paired", [("small", False),
                                           ("small_pe", True)])
def test_fused_program_golden_parity(gpu, tmp_path, trex1_index, prefix,
                                     paired):
    """The fused stage-1+2 program, compiled for the card, maps the small
    goldens byte-identically."""
    from abismal_tpu.map.engine import run_map
    from abismal_tpu.map.pipeline import make_tpu_native_engine_factory

    fq1 = golden_path(prefix + "_1.fq")
    fq2 = golden_path(prefix + "_2.fq") if paired else None
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq" if paired
            else f"tests/{prefix}_1.fq")
    cl = (f"map -s tests/{prefix}.mstats -o tests/{prefix}.sam "
          f"-i tests/tRex1.idx {tail}")
    sam, mst = tmp_path / "o.sam", tmp_path / "o.mstats"
    run_map(trex1_index, fq1, fq2, str(sam), str(mst), cl,
            engine_factory=make_tpu_native_engine_factory(n_threads=2))
    for out, ext in ((sam, ".sam"), (mst, ".mstats")):
        with gzip.open(os.path.join(GOLDEN, prefix + ext + ".gz"), "rt") as f:
            assert out.read_text() == f.read()
