"""The benchmark's tests: on the CPU with the port's plain path at small
sizes (``pytest plexbench/tests``), and with the ``gpu`` marker on the card.
They are not under ``tests/`` and the repository's own run does not collect
them."""
import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL_KEYS = 1_000_000


def shrink(root: pathlib.Path, n_keys: int = SMALL_KEYS) -> None:
    """Cut every configuration and mix under ``root`` to a size the CPU
    runs in seconds: ``n_keys`` keys, two build workers, 4,096-lane blocks,
    a 2^14-slot cache; two clients of 8 sizes of 1,024-8,192 keys over a
    2^18 pool."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["n_keys"] = n_keys
        svc = cfg["service"]
        svc.update(build_workers=2, block=4096,
                   cache_slots=min(svc["cache_slots"], 1 << 14))
        path.write_text(json.dumps(cfg))
    for path in (root / "plexbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(clients=2, size_min=1024, size_max=8192, size_steps=8,
                   pool_log2=18)
        path.write_text(json.dumps(mix))


@pytest.fixture(autouse=True)
def short_warm_up(monkeypatch):
    """The warm-up's traffic cut to half a second at these sizes."""
    from plexbench import harness
    monkeypatch.setattr(harness, "WARM_S", 0.5)


@pytest.fixture
def small_root(tmp_path) -> pathlib.Path:
    """A copy of the benchmark (``BENCHMARK.json`` and ``plexbench/``) cut
    to CPU sizes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "plexbench", tmp_path / "plexbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shrink(tmp_path)
    return tmp_path


@pytest.fixture
def card():
    """Skip without a CUDA card (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
