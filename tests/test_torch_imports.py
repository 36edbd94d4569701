"""Import hygiene and device defaults of the port.

* ``repro_torch`` imports with ``jax``, ``ml_dtypes``, ``msgpack``,
  ``zstandard`` and ``benchmarks`` blocked, and no module under
  ``src/repro_torch`` imports ``jax``, ``ml_dtypes``, anything of
  ``repro`` or ``benchmarks``, or ``msgpack``; ``zstandard`` appears only as
  the optional import of ``storage/codecs.py`` (zlib stands in without
  it);
* entry points default to CUDA and raise when none is present (no CPU
  fallback); ``device="cpu"`` is the explicit plain path;
* ``chip_smoke.py`` exits non-zero and prints no result without CUDA;
* the CUDA sources ship with the package and build under the ignored
  ``build/`` directory.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import DeepMappingConfig, DeepMappingStore, InferenceEngine, KeyEncoder
from repro_torch.core import model as tmodel
from repro_torch.data.tpch import orders_like
from repro_torch.kernels import bitvector as bv
from repro_torch.kernels import build
from repro_torch.kernels import fused_mlp as fm

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(PKG.rglob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _optional_imports(path: Path):
    """Modules imported inside ``try: ... except ImportError``."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(
            isinstance(h.type, ast.Name) and h.type.id == "ImportError" for h in node.handlers
        ):
            for stmt in node.body:
                if isinstance(stmt, ast.Import):
                    yield from (a.name for a in stmt.names)


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(PKG)) for p in MODULES])
def test_module_imports_neither_jax_nor_repro(path):
    optional = set(_optional_imports(path))
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "ml_dtypes", "repro", "benchmarks", "msgpack"), (
            f"{path.name} imports {name}")
        if top == "zstandard":
            assert path.relative_to(PKG) == Path("storage/codecs.py") and name in optional, (
                f"{path.name} imports zstandard")


def test_import_with_jax_blocked():
    mods = [
        "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in MODULES if p.name != "__init__.py"
    ]
    code = (
        "import sys\n"
        "for m in ('jax', 'ml_dtypes', 'msgpack', 'zstandard', 'benchmarks'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, repro_torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, mod in list(sys.modules.items())\n"
        "       if mod is not None and m.split('.')[0] in ('repro', 'jax', 'ml_dtypes', 'benchmarks')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    table = orders_like(500, seed=0)
    enc = KeyEncoder(table.max_key)
    spec = tmodel.MLPSpec(10, enc.width, (16,), {c: (8,) for c in table.columns},
                          {c: len(np.unique(v)) for c, v in table.columns.items()})
    return table, enc, spec, tmodel.init_params(spec, device="cpu")


class TestDeviceDefaults:
    def test_build_without_device_raises(self, no_cuda):
        table, _, spec, params = _small()
        with pytest.raises(RuntimeError, match="CUDA"):
            DeepMappingStore.build(table, DeepMappingConfig(), spec=spec, params=params)

    def test_engine_without_device_raises(self, no_cuda):
        _, enc, spec, params = _small()
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceEngine(enc, spec, params)
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceEngine(enc, spec, params, device="cuda")

    def test_init_params_without_device_raises(self, no_cuda):
        _, _, spec, _ = _small()
        with pytest.raises(RuntimeError, match="CUDA"):
            tmodel.init_params(spec)

    def test_cluster_without_device_raises(self, no_cuda, tmp_path):
        from repro_torch.cluster import ClusterConfig, ShardedDeepMappingStore

        table, _, _, _ = _small()
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedDeepMappingStore.build(table, DeepMappingConfig(), ClusterConfig(2))
        cluster = ShardedDeepMappingStore.build(
            table, DeepMappingConfig(shared=(8,), private=(4,)), ClusterConfig(2),
            device="cpu")
        assert all(s.device.type == "cpu" for s in cluster.shards)
        cluster.save(str(tmp_path / "c"))
        with pytest.raises(RuntimeError, match="CUDA"):
            repro_torch.open(str(tmp_path / "c"))

    def test_cpu_is_explicit(self):
        table, enc, spec, params = _small()
        store = DeepMappingStore.build(table, DeepMappingConfig(), spec=spec, params=params,
                                       device="cpu")
        assert store.device.type == "cpu" and store.engine.device.type == "cpu"
        _, exists = store.lookup(table.keys[:10])
        assert exists.all()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a GPU the script exits non-zero before any result; alone
    in a directory (no ``src/``) it cannot import the port either."""
    script = (ROOT / "chip_smoke.py").read_text()
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(script)
    for path in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                             cwd=path.parent, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_cuda_sources_ship_and_build_dir_is_ignored():
    assert set(build.SOURCES) == {"fused_mlp.cu", "bitvector.cu"}
    assert {fm.SOURCE, bv.SOURCE} == set(build.SOURCES)
    assert build.CSRC_DIR.name == "csrc"
    text = (ROOT / "pyproject.toml").read_text()
    assert "repro_torch" in text and "csrc/*.cu" in text
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    paths = set()
    for source in build.SOURCES:
        assert (build.CSRC_DIR / source).exists()
        lib = build.library_path(source)
        assert lib.resolve().relative_to(ROOT).parts[0] == "build"
        assert lib.name.startswith(f"lib{Path(source).stem}-") and lib.suffix == ".so"
        paths.add(lib)
    assert len(paths) == len(build.SOURCES)
    assert build.build_dir().resolve().relative_to(ROOT).parts[0] == "build"
    assert "-gencode" in build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_module_scan_covers_this_slices_modules():
    names = {str(p.relative_to(PKG)) for p in MODULES}
    assert {"train/optimizer.py", "kernels/bitvector.py", "kernels/build.py",
            "core/trainer.py"} <= names
    assert {"core/serialize.py", "storage/msgpack_codec.py", "fault/errors.py",
            "fault/injection.py", "obs/tracing.py", "obs/export.py", "api/cache.py",
            "api/entry.py", "api/executor.py", "api/protocol.py", "api/query.py",
            "api/routing.py"} <= names
    assert {"data/datasets.py", "data/tpcds.py", "baselines/__init__.py",
            "baselines/partitioned.py", "baselines/array_store.py", "baselines/hash_store.py",
            "core/multikey.py"} <= names
    assert {"fault/retry.py", "fault/health.py", "cluster/__init__.py",
            "cluster/partitioner.py", "cluster/router.py", "cluster/sharded_store.py",
            "api/federated.py"} <= names
    assert {"serve/__init__.py", "serve/engine.py", "launch/__init__.py",
            "launch/serve.py"} <= names
    assert {"core/mhas/__init__.py", "core/mhas/search_space.py",
            "core/mhas/controller.py"} <= names
    assert {"core/mhas/search.py", "configs/__init__.py",
            "configs/deepmapping_paper.py"} <= names
    assert {"models/__init__.py", "models/config.py", "models/layers.py",
            "models/attention.py", "models/transformer.py", "configs/base.py",
            "configs/tinyllama_1_1b.py", "configs/qwen2_7b.py", "configs/granite3_2b.py",
            "configs/gemma3_1b.py", "configs/phi3_vision_4_2b.py",
            "serve/serve_step.py"} <= names
    assert {"train/train_step.py", "train/checkpoint.py", "train/fault_tolerance.py",
            "train/compression.py", "data/tokens.py", "data/loader.py",
            "launch/train.py"} <= names
    assert {"models/ssm.py", "configs/rwkv6_7b.py", "configs/recurrentgemma_2b.py"} <= names


def test_chip_smoke_imports_none_of_the_forbidden_modules():
    for name in _imports(ROOT / "chip_smoke.py"):
        assert name.split(".")[0] not in (
            "jax", "jaxlib", "ml_dtypes", "repro", "benchmarks", "msgpack", "zstandard"), name
