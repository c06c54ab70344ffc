"""Device alignment and compare arithmetic vs the host aligner and NumPy
oracles.  On the CPU the Triton kernels run in Pallas interpret mode; the
compiled kernels are checked on the GPU by the `gpu`-marked tests."""

import numpy as np
import pytest


@pytest.mark.slow
def test_banded_score_kernel_matches_aligner(trex1_index):
    from abismal_tpu.kernels.banded_align import score_jobs
    from abismal_tpu.map.align import BandedAligner
    from abismal_tpu.map.seeds import SeedIndexView, prep_read

    view = SeedIndexView(trex1_index)
    aln = BandedAligner(view.nib)
    aln.reset(128)

    rng = np.random.default_rng(5)
    nib_to_char = np.frombuffer(b"ZACMGRSVTWYHKDBN", dtype=np.uint8)
    jobs = []
    expected = []
    for _ in range(16):
        p = int(rng.integers(40000, 900000))
        length = int(rng.integers(80, 120))
        s = bytearray(
            nib_to_char[view.nib[p : p + length]].tobytes().replace(b"Z", b"A")
        )
        for _ in range(int(rng.integers(0, 8))):
            s[int(rng.integers(0, length))] = ord(rng.choice(list("ACGT")))
        q = prep_read(bytes(s), bool(rng.integers(0, 2)))
        diffs = int(rng.integers(1, 30))
        max_diffs = int(rng.integers(5, 15))
        jobs.append((q, diffs, max_diffs, p))
        expected.append(aln.align(diffs, max_diffs, q, p, False))

    got = score_jobs(view.nib, jobs, interpret=True)
    assert got == expected


def test_native_aligner_matches_numpy_oracle(trex1_index):
    """The native C++ aligner must agree with the pure-NumPy reference
    implementation, including traceback cigars."""
    from abismal_tpu.map.align import BandedAligner
    from abismal_tpu.map.seeds import SeedIndexView, prep_read

    view = SeedIndexView(trex1_index)
    nat = BandedAligner(view.nib, use_native=True)
    ora = BandedAligner(view.nib, use_native=False)
    nat.reset(128)
    ora.reset(128)

    rng = np.random.default_rng(6)
    nib_to_char = np.frombuffer(b"ZACMGRSVTWYHKDBN", dtype=np.uint8)
    for _ in range(40):
        p = int(rng.integers(40000, 900000))
        length = int(rng.integers(60, 128))
        s = bytearray(
            nib_to_char[view.nib[p : p + length]].tobytes().replace(b"Z", b"A")
        )
        for _ in range(int(rng.integers(0, 10))):
            s[int(rng.integers(0, length))] = ord(rng.choice(list("ACGT")))
        q = prep_read(bytes(s), bool(rng.integers(0, 2)))
        diffs = int(rng.integers(1, 30))
        max_diffs = int(rng.integers(5, 15))
        s_nat = nat.align(diffs, max_diffs, q, p, True)
        s_ora = ora.align(diffs, max_diffs, q, p, True)
        assert s_nat == s_ora
        c_nat = nat.build_cigar_len_and_pos(diffs, max_diffs, p)
        c_ora = ora.build_cigar_len_and_pos(diffs, max_diffs, p)
        assert c_nat == c_ora


def test_popcount_compare_kernel_matches_oracle():
    """The plain-XLA popcount compare (pipeline.popcount_compare) vs a
    direct NumPy evaluation of full_compare's word form
    (abismal.cpp:1105-1122)."""
    import jax

    from abismal_tpu.map.pipeline import popcount_compare

    rng = np.random.default_rng(11)
    for g, aw, nw in ((96, 64, 16), (1024, 64, 16), (513, 96, 64)):
        A = rng.integers(0, 1 << 32, size=(g, aw), dtype=np.uint32)
        pk = rng.integers(0, 1 << 32, size=(g, nw), dtype=np.uint32)
        ow = rng.integers(0, 32, size=g).astype(np.int32)
        sh = (rng.integers(0, 8, size=g).astype(np.uint32)) * np.uint32(4)
        nwv = rng.integers(0, nw + 1, size=g).astype(np.int32)

        got = np.asarray(jax.jit(popcount_compare)(A, pk, ow, sh, nwv))

        want = np.zeros(g, np.int64)
        for i in range(g):
            row = np.roll(A[i], -int(ow[i]))
            row[aw - int(ow[i]):] = 0
            for j in range(int(nwv[i])):
                win = np.uint32(
                    (int(row[j]) >> int(sh[i]))
                    | ((int(row[j + 1]) << (31 - int(sh[i]))) << 1)
                    & 0xFFFFFFFF)
                want[i] += 8 - bin(int(pk[i, j]) & int(win)).count("1")
        np.testing.assert_array_equal(got.astype(np.int64), want)


def _trex1_jobs(trex1_index, n):
    from abismal_tpu.map.align import BandedAligner
    from abismal_tpu.map.seeds import SeedIndexView
    from chip_smoke import mutated_jobs

    nib = SeedIndexView(trex1_index).nib
    jobs = mutated_jobs(nib, n, seed=9)
    aln = BandedAligner(nib, use_native=True)
    aln.reset(128)
    scores, cigars = [], []
    for q, d, md, p in jobs:
        scores.append(aln.align(d, md, q, p, True))
        cigars.append(aln.build_cigar_len_and_pos(d, md, p))
    return nib, jobs, np.array(scores), cigars


@pytest.mark.parametrize("impl", ["triton", "xla"])
def test_banded_scorer_matches_aligner(trex1_index, impl):
    """The Triton scorer (Pallas interpret mode on the CPU) and the
    plain-XLA recurrence score mutated tRex1 jobs exactly like the host
    aligner at lmax 128."""
    from abismal_tpu.kernels.banded_align import (
        build_banded_scorer, prepare_jobs,
    )

    nib, jobs, want, _ = _trex1_jobs(trex1_index, 256)
    q, win, bw, qsz, _ = prepare_jobs(nib, jobs, 128)
    scorer = build_banded_scorer(128, interpret=True, impl=impl)
    got = np.asarray(scorer(q, win, bw, qsz))[: len(jobs), 0]
    np.testing.assert_array_equal(got, want)


def test_banded_tracer_matches_native_traceback(trex1_index):
    """The Triton tracer (interpret mode) plus the device walk reproduce
    the native traceback's cigars, aligned lengths and positions, and its
    panel and argmax equal the plain-XLA tracer's."""
    from abismal_tpu.kernels.banded_align import (
        build_banded_tracer, prepare_jobs,
    )
    from abismal_tpu.map.pipeline import build_tb_block
    from chip_smoke import assemble_cigar

    nib, jobs, scores, cigars = _trex1_jobs(trex1_index, 256)
    q, win, bw, qsz, _ = prepare_jobs(nib, jobs, 128)
    pos = np.array([p for *_, p in jobs], dtype=np.uint32)
    tb = build_tb_block(128, interpret=True)
    ops, meta = (np.asarray(a) for a in tb(
        q, win, bw[:, 0], qsz[:, 0], pos, np.ones(len(jobs), bool)))
    n = 0
    for i, (qq, *_r) in enumerate(jobs):
        got = assemble_cigar(ops[i], meta[i], qq.shape[0])
        if scores[i] <= 0 or got is None:
            continue
        c, ln, p = cigars[i]
        assert got == (c, ln, p % (1 << 32)), i
        n += 1
    assert n > 200
    tri = build_banded_tracer(128, interpret=True, impl="triton")(
        q, win, bw, qsz)
    xla = build_banded_tracer(128, interpret=True, impl="xla")(
        q, win, bw, qsz)
    for a, b in zip(tri, xla):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
