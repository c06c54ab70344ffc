"""Where the device engine runs: the backend chooser, the compile cache
and the one-card-per-process rule for --hosts."""

import os
import subprocess
import sys

import pytest

from tests.conftest import golden_path


def test_device_backend_choice():
    from abismal_tpu.map.pipeline import device_backend

    assert device_backend("gpu", "") == "gpu"
    assert device_backend("gpu", "cuda") == "gpu"
    assert device_backend("cpu", "cpu") == "cpu"
    for backend, platforms in (("cpu", ""), ("cpu", "cuda,cpu"),
                               ("tpu", "")):
        with pytest.raises(RuntimeError, match="needs a GPU"):
            device_backend(backend, platforms)


def test_engine_tpu_refuses_implicit_cpu(tmp_path, trex1_index):
    """Without JAX_PLATFORMS=cpu a machine with no GPU must not run
    --engine tpu on the CPU: the CLI exits with an error."""
    from tests.conftest import CACHE

    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run(
        [sys.executable, "-m", "abismal_tpu", "map", "--engine", "tpu",
         "-i", os.path.join(CACHE, "tRex1.idx"), "-o",
         str(tmp_path / "o.sam"), golden_path("small_1.fq")],
        capture_output=True, text=True, env=env, cwd=repo, timeout=300)
    assert p.returncode == 1
    assert "needs a GPU" in p.stderr
    assert not (tmp_path / "o.sam").exists()


class _FakeConfig:
    def __init__(self):
        self.updates = {}

    def update(self, k, v):
        self.updates[k] = v


class _FakeJax:
    def __init__(self):
        self.config = _FakeConfig()


def test_compile_cache_location(monkeypatch, tmp_path):
    from abismal_tpu.map.pipeline import (
        DEFAULT_CACHE_DIR, configure_compile_cache,
    )

    fake = _FakeJax()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert configure_compile_cache(fake) == str(tmp_path)
    assert "jax_compilation_cache_dir" not in fake.config.updates

    fake = _FakeJax()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert configure_compile_cache(fake) == DEFAULT_CACHE_DIR
    assert fake.config.updates["jax_compilation_cache_dir"] == \
        DEFAULT_CACHE_DIR
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")


def test_hosts_pin_one_card_per_shard(monkeypatch):
    from abismal_tpu.parallel.multihost import (
        shard_device_envs, visible_cards,
    )

    cards = ["0", "1", "2", "3"]
    assert shard_device_envs(3, "tpu", platforms="", cards=cards) == [
        {"CUDA_VISIBLE_DEVICES": c} for c in ("0", "1", "2")]
    with pytest.raises(ValueError, match="one GPU per shard"):
        shard_device_envs(5, "tpu", platforms="", cards=cards)
    with pytest.raises(ValueError, match="one GPU per shard"):
        shard_device_envs(1, "tpu", platforms="cuda", cards=[])
    # host-engine shards and explicit CPU runs open no card
    assert shard_device_envs(5, "native", platforms="", cards=[]) == \
        [{}] * 5
    assert shard_device_envs(2, "tpu", platforms="cpu", cards=[]) == \
        [{}, {}]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,5")
    assert visible_cards() == ["2", "5"]
    assert shard_device_envs(2, "tpu", platforms="")[1] == \
        {"CUDA_VISIBLE_DEVICES": "5"}
