"""The port stands alone: it imports torch and numpy, never JAX and never
the JAX package."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "lightmotif_tpu_torch"


def test_import_leaves_jax_out(tmp_path):
    code = (
        "import sys\n"
        "import lightmotif_tpu_torch as lm\n"
        "import lightmotif_tpu_torch.ops.build, lightmotif_tpu_torch.convert\n"
        "import lightmotif_tpu_torch.ops.multi, lightmotif_tpu_torch.scanner\n"
        "import lightmotif_tpu_torch.batch\n"
        "import lightmotif_tpu_torch.io, lightmotif_tpu_torch.fasta\n"
        "import lightmotif_tpu_torch.native, lightmotif_tpu_torch.cli\n"
        "import lightmotif_tpu_torch.tfmpvalue, lightmotif_tpu_torch.sampler\n"
        "import lightmotif_tpu_torch.sampler_batch, lightmotif_tpu_torch.parallel\n"
        "import lightmotif_tpu_torch.parallel.mesh, lightmotif_tpu_torch.utils.profiling\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'lightmotif_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_sources_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|lightmotif_tpu)\b",
                         re.MULTILINE)
    sources = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 10
    for path in sources:
        assert not pattern.search(path.read_text()), path


def test_kernel_sources_ship_with_the_package():
    for name in ("score.cu", "prefilter.cu"):
        assert (PACKAGE / "ops" / "csrc" / name).is_file()


def test_native_source_ships_with_the_package():
    assert (PACKAGE / "_native" / "lightmotif_native.cpp").is_file()
    pyproject = (ROOT / "pyproject.toml").read_text()
    assert '"lightmotif_tpu_torch._native" = ["*.cpp"]' in pyproject
    assert 'lightmotif-tpu-torch = "lightmotif_tpu_torch.cli:main"' in pyproject


#: The modules of the last slice, each beside its JAX counterpart.
MODULES = ["tfmpvalue", "sampler", "sampler_batch", "parallel", "parallel.mesh",
           "utils", "utils.profiling"]


def test_the_port_exports_what_the_jax_package_exports():
    import lightmotif_tpu
    import lightmotif_tpu_torch

    assert lightmotif_tpu_torch.__all__ == lightmotif_tpu.__all__
    for name in lightmotif_tpu_torch.__all__:
        assert getattr(lightmotif_tpu_torch, name).__module__.startswith(
            "lightmotif_tpu_torch"), name


def test_every_jax_module_has_its_counterpart():
    """Each module of the JAX package has one of the same name in the
    port, but ``utils/cache.py`` (JAX's compile cache), whose counterpart
    is ``ops/build.py``'s build directory."""
    jax_root = ROOT / "lightmotif_tpu"
    missing = sorted(str(p.relative_to(jax_root)) for p in jax_root.rglob("*.py")
                     if not (PACKAGE / p.relative_to(jax_root)).is_file())
    assert missing == ["ops/xla_ops.py", "utils/cache.py"], missing
    assert (PACKAGE / "ops" / "torch_ops.py").is_file()  # xla_ops' counterpart
    assert (PACKAGE / "ops" / "build.py").is_file()  # the cache's


@pytest.mark.parametrize("module", MODULES)
def test_new_modules_match_the_jax_public_names(module):
    import importlib

    mine = importlib.import_module(f"lightmotif_tpu_torch.{module}")
    theirs = importlib.import_module(f"lightmotif_tpu.{module}")
    assert set(getattr(theirs, "__all__", [])) <= set(getattr(mine, "__all__", [])), module
    assert not pattern_import.search(pathlib.Path(mine.__file__).read_text()), module


pattern_import = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|lightmotif_tpu)\b", re.MULTILINE)
