import gzip
import hashlib
import os
import shutil
import tempfile

import pytest

# The suite runs on the CPU: JAX_PLATFORMS=cpu (Pallas kernels in interpret
# mode) over 8 virtual devices for the mesh tests.  Forced, not
# setdefault: an ambient JAX_PLATFORMS pointing at an accelerator must not
# move the parity tests onto it.  ABISMAL_TEST_DEVICE=gpu leaves JAX on its
# default platform instead, for the `gpu`-marked tests on a card:
#   ABISMAL_TEST_DEVICE=gpu python -m pytest -m gpu tests/
if os.environ.get("ABISMAL_TEST_DEVICE") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "--xla_force_host_platform_device_count" not in os.environ.get(
            "XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
    # jax may already be imported (and have read the ambient setting)
    if "jax" in __import__("sys").modules:
        import jax

        jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
DATA = os.path.join(HERE, "data")
CACHE = os.path.join(tempfile.gettempdir(), "abismal_tpu_test_cache")


def md5_file(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def golden_path(name: str, tmpdir=CACHE) -> str:
    """Decompress tests/golden/<name>.gz into the cache dir and return the
    path."""
    os.makedirs(tmpdir, exist_ok=True)
    out = os.path.join(tmpdir, name)
    src = os.path.join(GOLDEN, name + ".gz")
    if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
        with gzip.open(src, "rb") as f, open(out, "wb") as g:
            shutil.copyfileobj(f, g)
    return out


@pytest.fixture(scope="session")
def trex1_fa() -> str:
    return os.path.join(DATA, "tRex1.fa")


@pytest.fixture(scope="session")
def trex1_index(trex1_fa):
    """Session-cached AbismalIndex for tRex1 (builds once, caches the
    serialized file on disk keyed by the golden md5)."""
    from abismal_tpu.index.build import create_index
    from abismal_tpu.index.serialize import read_index, write_index

    os.makedirs(CACHE, exist_ok=True)
    want_md5 = open(os.path.join(GOLDEN, "tRex1.idx.md5")).read().strip()
    cached = os.path.join(CACHE, "tRex1.idx")
    if not (os.path.exists(cached) and md5_file(cached) == want_md5):
        idx = create_index(trex1_fa)
        write_index(idx, cached)
        assert md5_file(cached) == want_md5, "index not byte-identical"
        return idx
    return read_index(cached)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's backend is a GPU (the `gpu` marker's
    fixture: decided here, at run time, never at import)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: ABISMAL_TEST_DEVICE=gpu python -m pytest "
                    "-m gpu tests/")
