"""The port stands alone: it imports torch and numpy, never JAX and never
the JAX package."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "lightmotif_tpu_torch"


def test_import_leaves_jax_out(tmp_path):
    code = (
        "import sys\n"
        "import lightmotif_tpu_torch as lm\n"
        "import lightmotif_tpu_torch.ops.build, lightmotif_tpu_torch.convert\n"
        "import lightmotif_tpu_torch.ops.multi, lightmotif_tpu_torch.scanner\n"
        "import lightmotif_tpu_torch.batch\n"
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
