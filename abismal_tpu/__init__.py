"""abismal-tpu: a bisulfite read-mapping engine for an NVIDIA GPU.

A from-scratch re-design of the abismal WGBS read mapper
(smithlabcode/abismal v3.3.0) as batched device programs (first built for
a TPU, hence the name): the hybrid two-letter / three-letter hash index
lives in device memory, read batches are mapped data-parallel under
jit/shard_map, and the hot kernels (bisulfite-aware popcount filter,
banded alignment) run on-device, with host-side Python/C++ for I/O, index
serialization and SAM emission.

Subpackages:
  constants  -- seed / scoring / flag constants (reference parity values)
  utils      -- DNA encodings and small helpers
  io         -- FASTA/FASTQ readers, SAM text writer, mapping statistics
  index      -- index build (host + device) and reference-format serialization
  sim        -- WGBS read simulator (bit-compatible with `abismal sim`)
  map        -- mapping engines: exact oracle and the device pipeline
  kernels    -- Pallas-Triton banded alignment kernels (+ plain-XLA twin)
  parallel   -- mesh / sharding helpers for multi-device runs
"""

__version__ = "0.1.0"

import os as _os

# numpy madvises allocations >= 4 MB to transparent hugepages by default;
# on hosts where a fresh 2M THP fault is slow (VM memory ballooning, direct
# compaction under madvise-mode defrag) that makes every big allocation
# 20-30x slower than plain 4K faults -- measured 20s vs 0.6s for a 1 GB
# copy on the dev VM, and it was the dominant source of run-to-run timing
# variance.  Always disabled here; the native engine instead
# MADV_COLLAPSEs its big RESIDENT tables at init (the fast THP path --
# +10-27% mapping throughput; ABISMAL_THP=0 turns that off).  Set
# NUMPY_MADVISE_HUGEPAGE=1 explicitly to restore numpy's behavior.
if _os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0") == "0":
    try:
        import numpy as _np

        try:
            _np._core.multiarray._set_madvise_hugepage(False)
        except AttributeError:  # numpy < 2
            _np.core.multiarray._set_madvise_hugepage(False)
    except Exception:
        pass
