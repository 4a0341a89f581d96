"""The kernels' build directory and the production/probe split of
``lightmotif_tpu_torch.ops.build``, without nvcc: a stand-in compiler
writes each library it is asked for."""

import pathlib
import re
import sys
import tempfile

import pytest

from lightmotif_tpu_torch.ops import build

PACKAGE = pathlib.Path(build.__file__).resolve().parents[1]

FAKE_NVCC = """\
#!{python}
import sys
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "w") as fh:
    fh.write("not a library")
with open({log!r}, "a") as fh:
    fh.write(sys.argv[-1] + "\\n")
print("ptxas info: stand-in")
"""


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """A process state with nothing resolved or built, and an environment
    with no build-directory choice."""
    monkeypatch.setattr(build, "_DIR", None)
    monkeypatch.setattr(build, "_INFO", {})
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.delenv(build.ENV, raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    return tmp_path


def blocked(path: pathlib.Path) -> pathlib.Path:
    """A directory path that cannot be created, even by root: its parent
    is a read-only directory in which a regular file holds the name."""
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("a file, not a directory")
    path.parent.chmod(0o555)
    return path


@pytest.fixture
def read_only_package(fresh, monkeypatch):
    package = blocked(fresh / "site-packages" / "ops" / "_build")
    monkeypatch.setattr(build, "PACKAGE_BUILD_DIR", package)
    yield package
    package.parent.chmod(0o755)


def test_env_path_is_the_build_directory(fresh, monkeypatch):
    target = fresh / "cache" / "cuda"
    monkeypatch.setenv(build.ENV, str(target))
    assert build.resolve_build_dir() == target
    assert target.is_dir()


@pytest.mark.parametrize("value", ["0", "off", "false", "OFF", ""])
def test_env_off_gives_a_fresh_temporary_directory(fresh, monkeypatch, value):
    monkeypatch.setenv(build.ENV, value)
    a, b = build.resolve_build_dir(), build.resolve_build_dir()
    assert a != b
    for d in (a, b):
        assert d.is_dir() and d.parent == fresh / "tmp"
        assert d != build.PACKAGE_BUILD_DIR


def test_unset_uses_the_package_directory_when_writable(fresh, monkeypatch):
    package = fresh / "pkg" / "_build"
    monkeypatch.setattr(build, "PACKAGE_BUILD_DIR", package)
    assert build.resolve_build_dir() == package


def test_unset_with_a_read_only_package_uses_the_user_cache(
        read_only_package, fresh, monkeypatch):
    monkeypatch.setenv("HOME", str(fresh / "home"))
    assert build.resolve_build_dir() == fresh / "home" / ".cache" / "lightmotif-tpu" / "cuda"


def test_nothing_writable_raises_with_the_paths_tried(read_only_package, fresh, monkeypatch):
    home = blocked(fresh / "locked" / "home")
    monkeypatch.setenv("HOME", str(home))
    try:
        with pytest.raises(RuntimeError) as e:
            build.resolve_build_dir()
    finally:
        home.parent.chmod(0o755)
    assert str(read_only_package) in str(e.value) and str(home) in str(e.value)
    assert build.ENV in str(e.value)


def test_an_unwritable_env_path_raises(fresh, monkeypatch):
    target = blocked(fresh / "locked" / "cache")
    monkeypatch.setenv(build.ENV, str(target))
    try:
        with pytest.raises(RuntimeError, match=re.escape(str(target))):
            build.resolve_build_dir()
    finally:
        target.parent.chmod(0o755)


def test_build_dir_resolves_once_and_the_cli_choice_overrides(fresh, monkeypatch):
    monkeypatch.setenv(build.ENV, str(fresh / "one"))
    assert build.build_dir() == fresh / "one"
    monkeypatch.setenv(build.ENV, str(fresh / "two"))
    assert build.build_dir() == fresh / "one"
    build.use_compile_cache(True)
    assert build.build_dir() == fresh / "one"
    build.use_compile_cache(False)
    assert build.build_dir().parent == fresh / "tmp"


@pytest.fixture
def fake_nvcc(fresh, monkeypatch):
    log = fresh / "nvcc.log"
    script = fresh / "nvcc"
    script.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    script.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(script))
    return log


def test_a_read_only_package_still_builds(read_only_package, fresh, fake_nvcc, monkeypatch):
    monkeypatch.setenv("HOME", str(fresh / "home"))
    info = build.build_info()
    cache = fresh / "home" / ".cache" / "lightmotif-tpu" / "cuda"
    assert [p.parent for p in info["paths"]] == [cache] * len(build.PRODUCTION_SOURCES)
    assert all(p.is_file() for p in info["paths"])
    assert not list(read_only_package.parent.glob("liblm-*"))


def test_production_build_leaves_the_probes_out(fresh, fake_nvcc, monkeypatch):
    monkeypatch.setenv(build.ENV, str(fresh / "cache"))
    info = build.build_info()
    built = sorted(pathlib.Path(line).name for line in fake_nvcc.read_text().split())
    # compiled together, in any order
    assert built == ["pairs.cu", "phase_c.cu", "prefilter.cu", "scan.cu", "score.cu"]
    assert [p.name.split("-")[1] for p in info["compiled"]] == ["score", "scan", "prefilter",
                                                                "phase_c", "pairs"]
    assert build.build_info() is info  # built once per process
    probes = build.build_info(probes=True)
    built = [pathlib.Path(line).name for line in fake_nvcc.read_text().split()]
    assert sorted(built[len(build.PRODUCTION_SOURCES):]) == ["probe_gmma.cu", "probes.cu"]
    assert [p.name.split("-")[1] for p in probes["compiled"]] == ["probes", "probe_gmma"]
    assert probes["paths"][:len(build.PRODUCTION_SOURCES)] == info["paths"]
    # a second process finds every library and compiles nothing
    monkeypatch.setattr(build, "_INFO", {})
    assert build.build_info(probes=True)["compiled"] == []
    assert build.build_info(probes=True)["seconds"] == 0.0


def test_symbol_sets_split_production_from_probes():
    production, probes = set(build.PRODUCTION_SYMBOLS), set(build.PROBE_SYMBOLS)
    assert production and probes and not production & probes
    text = {name: (build.CSRC / name).read_text()
            for name in build.PRODUCTION_SOURCES + build.PROBE_SOURCES}
    defined = lambda name, sources: any(  # noqa: E731
        re.search(rf"^(int|long long) {name}\(", text[s], re.MULTILINE) for s in sources)
    for name in production:
        assert defined(name, build.PRODUCTION_SOURCES), name
    for name in probes:
        assert defined(name, build.PRODUCTION_SOURCES + build.PROBE_SOURCES), name
    # everything the sources export is in one set or the other
    exported = set(re.findall(r"^(?:int|long long) (lm_\w+)\(", "".join(text.values()),
                              re.MULTILINE))
    assert exported == production | probes


def test_production_wrappers_reach_library_and_probes_probe_library():
    for rel in ("ops/kernels.py", "ops/multi_kernel.py", "ops/multi_stages.py"):
        src = (PACKAGE / rel).read_text()
        assert "build.library()" in src and "probe_library" not in src, rel
    for path in sorted((PACKAGE / "probes").glob("*.py")):
        src = path.read_text()
        if "build" in src:
            assert "build.probe_library()" in src and "build.library()" not in src, path
