"""Regression: mixed-case genome with IUPAC ambiguity codes.  IUPAC nibbles
carry multiple bits, so the bisulfite-aware popcount 'distance' can go
NEGATIVE; the reference's size_t cast then selects the full alignment band
(AbismalAlign.hpp:332-334).  Pinned md5s were validated byte-for-byte
against the upstream binary on 2026-08-17."""

import hashlib

import numpy as np
import pytest

IDX_MD5 = "fd50f44d8ea4ae6f9dec23121e624b64"
SAM_BODY_MD5 = "fedf1e01d194c0e305156931b2dd3310"
MSTATS_MD5 = "146899941bbc5d24b68a571729fa07c3"


def _build_genome(path):
    rng = np.random.default_rng(123)
    n = 300000
    seq = rng.choice(list("ACGT"), size=n)
    low = rng.random(n) < 0.3
    seq = np.where(low, np.char.lower(seq.astype("U1")), seq)
    iup = rng.integers(0, n, 200)
    seq[iup] = rng.choice(list("RYSWKMBDHVN"), size=200)
    for s, ln in [(5000, 400), (100000, 2000)]:
        seq[s : s + ln] = "N"
    with open(path, "w") as f:
        f.write(">chrA test desc\n")
        s1 = "".join(seq[:250000])
        for i in range(0, len(s1), 70):
            f.write(s1[i : i + 70] + "\n")
        f.write(">chrB\n")
        s2 = "".join(seq[250000:])
        for i in range(0, len(s2), 70):
            f.write(s2[i : i + 70] + "\n")


def _md5(path):
    return hashlib.md5(open(path, "rb").read()).hexdigest()


@pytest.mark.slow
def test_iupac_genome_index_and_map(tmp_path):
    from abismal_tpu.index.build import create_index
    from abismal_tpu.index.serialize import write_index
    from abismal_tpu.map.engine import run_map
    from abismal_tpu.sim.simreads import SimConfig, simulate_reads

    fa = tmp_path / "g1.fa"
    _build_genome(str(fa))
    idx = create_index(str(fa))
    idx_file = tmp_path / "g1.idx"
    write_index(idx, str(idx_file))
    assert _md5(str(idx_file)) == IDX_MD5

    simulate_reads(str(fa), SimConfig(
        output_prefix=str(tmp_path / "gi"), n_reads=150,
        mutation_rate=0.02, bs_conv=0.96, seed=12))
    sam = tmp_path / "g.sam"
    mst = tmp_path / "g.mstats"
    run_map(idx, str(tmp_path / "gi_1.fq"), str(tmp_path / "gi_2.fq"),
            str(sam), str(mst), "cl")
    body = "\n".join(
        ln for ln in sam.read_text().splitlines() if not ln.startswith("@"))
    assert hashlib.md5(body.encode()).hexdigest() == SAM_BODY_MD5
    assert _md5(str(mst)) == MSTATS_MD5


def _negdiff_fixture(tmp_path):
    """Genome whose Y (C|T) codes make T-rich popcount distances NEGATIVE:
    a read 'T' over genome 'Y' contributes popcount(0b1010 & 0b1010)-1 = +1
    match surplus, so an otherwise-exact read spanning k Y codes arrives at
    the candidate gates with diffs = -k < 0."""
    from abismal_tpu.index.build import create_index

    rng = np.random.default_rng(77)
    n = 120000
    seq = rng.choice(list("ACGT"), size=n)
    yspots = rng.integers(200, n - 200, 400)
    seq[yspots] = "Y"
    fa = tmp_path / "negd.fa"
    with open(fa, "w") as f:
        f.write(">chrY\n")
        s = "".join(seq)
        for i in range(0, n, 70):
            f.write(s[i : i + 70] + "\n")
    idx = create_index(str(fa))

    # reads copied from the genome with C->T (bisulfite) and Y->T: each Y
    # under the read is a negative-diff position for the T-rich encoding
    reads = []
    L = 100
    for i, p in enumerate(sorted(set(int(y) for y in yspots))[:48]):
        s0 = max(0, min(p - L // 2, n - L))
        r = "".join(seq[s0 : s0 + L]).replace("C", "T").replace("Y", "T")
        reads.append((f"nd{i}", r.encode()))
    return idx, reads


def test_fused_stage2_negative_diffs_parity(tmp_path):
    """Regression (ADVICE r4 high): the fused SE stage-1+2 packed raw
    diffs into a 10-bit field, so IUPAC-driven NEGATIVE diffs smeared sign
    bits over the strand code and the candidate was silently dropped.
    Diffs must ride the field +512-biased; output must equal the exact
    native engine with the reads staying on the device path."""
    import io

    from abismal_tpu.map.native_engine import NativeMappingEngine
    from abismal_tpu.map.pipeline import TpuNativeEngine
    from abismal_tpu.map.stats import SEStats

    idx, reads = _negdiff_fixture(tmp_path)

    tpu = TpuNativeEngine(idx, unit_batch=128, n_threads=2,
                          device_stage2=True)
    out_t, st_t = io.StringIO(), SEStats()
    tpu.map_se_reads(reads, False, False, st_t, out_t)

    host = NativeMappingEngine(idx, n_threads=2)
    out_h, st_h = io.StringIO(), SEStats()
    host.map_se_reads(reads, False, False, st_h, out_h)

    assert out_t.getvalue() == out_h.getvalue()
    assert st_t.__dict__ == st_h.__dict__
    # the fixture must actually exercise the device path and map reads
    # (anything else and this test pins nothing)
    assert st_h.reads_mapped_unique > 0
    assert tpu.n_fallback < len(reads) // 2


def test_fused_stage2pe_zero_diff_iupac_parity(tmp_path):
    """Regression: a PE candidate whose IUPAC-biased popcount distance is
    0 despite a real mismatch must be scored as the reference scores
    every zero-diffs candidate (best_single_score, no alignment), not by
    the banded DP; otherwise the mated end's NM (recovered from that
    score) differs.  Simulated pairs over the Y-code genome hit this case
    (one Y surplus cancelling one mutation)."""
    from abismal_tpu.map.engine import run_map
    from abismal_tpu.map.pipeline import (
        make_native_engine_factory, make_tpu_native_engine_factory,
    )
    from abismal_tpu.sim.simreads import SimConfig, simulate_reads

    idx, _reads = _negdiff_fixture(tmp_path)
    simulate_reads(str(tmp_path / "negd.fa"), SimConfig(
        output_prefix=str(tmp_path / "p"), n_reads=600, mutation_rate=0.01,
        bs_conv=0.98, seed=5))
    fq1, fq2 = str(tmp_path / "p_1.fq"), str(tmp_path / "p_2.fq")
    outs = []
    for fac in (make_tpu_native_engine_factory(unit_batch=512, n_threads=2),
                make_native_engine_factory(n_threads=2)):
        sam = tmp_path / f"o{len(outs)}.sam"
        run_map(idx, fq1, fq2, str(sam), None, "cl", engine_factory=fac,
                threads=2)
        outs.append(sam.read_text())
    assert outs[0] == outs[1]
    assert outs[1].count("NM:i:0") > 100
