"""The port's chip tools on the CPU: every switch
``tools/kernel_breakdown.py`` applies to the port's kernels still finds its
anchor, once, in the sources as they stand, so an edit to a kernel that
breaks the tool shows here and not on the next run on the card;
``tools/search_shapes.py`` times the shapes the GPU tests use; and
``tools/build_breakdown.py``'s stages account for a whole build."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "kernel_breakdown", ROOT / "tools" / "kernel_breakdown.py")
kb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kb)

CASES = ([("decode_attention.cu", kb.B3_SWITCHES, row) for row in kb.B3_ROWS]
         + [("flash_attention.cu", kb.B4_SWITCHES, row)
            for row in kb.B4_ROWS]
         + [("mips_tc.cuh", kb.MIPS_SWITCHES, row) for row in kb.MIPS_ROWS])


@pytest.mark.parametrize("source,switches,row", CASES,
                         ids=[f"{c[0]}:{c[2]}" for c in CASES])
def test_kernel_breakdown_switches_find_their_anchors(source, switches, row):
    src = (kb.CSRC / source).read_text()
    out = kb.patched(src, switches, row)
    for name in row.split("+"):
        if name != "base":
            old, new = switches[name]
            assert src.count(old) == 1 and new in out
    assert (out == src) == (row == "base")


def test_kernel_breakdown_refuses_a_missing_anchor():
    with pytest.raises(SystemExit, match="not found once"):
        kb.patched("// no kernel here\n", kb.B3_SWITCHES, "no_merge")


def test_search_shapes_are_the_gpu_tests_shapes():
    """tools/search_shapes.py times B1 and B2 at the shapes the GPU tests
    hold them to."""
    spec = importlib.util.spec_from_file_location(
        "search_shapes", ROOT / "tools" / "search_shapes.py")
    ss = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ss)
    spec = importlib.util.spec_from_file_location(
        "gpu_tests", ROOT / "tests" / "test_torch_gpu.py")
    gt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gt)
    assert ss.MIPS_SHAPES == gt.MIPS_SHAPES


def test_build_breakdown_stages_account_for_the_build(tmp_path):
    """tools/build_breakdown.py at a small size on the CPU (its wall times
    here are not device numbers): the stages and the rest of the loop sum
    to the run, each candidate is one oracle call, each wave one encode,
    and the dedup index crosses into IVF."""
    import sys
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location(
        "build_breakdown", ROOT / "tools" / "build_breakdown.py")
    bb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bb)
    out = bb.breakdown(700, 20, "cpu", flat_max_rows=256, window_at=400,
                       window=3, work=tmp_path / "store")
    st = out["stages"]
    assert out["generated"] == 700 and out["index_mode"] == "ivf"
    assert out["refits"] == 2 and st["dedup refit"]["calls"] == 2
    assert sum(v["seconds"] for v in st.values()) == \
        pytest.approx(out["run_seconds"], rel=1e-9)
    assert st["encode (hash)"]["calls"] == out["waves"] == \
        st["dedup max_sim"]["calls"] + 1          # the first wave: empty
    assert st["answer (oracle LM)"]["calls"] == 700
    assert st["generate (oracle LM)"]["calls"] >= 700 + out["discarded"]
    assert out["window"]["mode"] == "ivf" and out["window"]["rows"] >= 400
    assert out["flat_pairs_per_sec"] > 0 and out["ivf_pairs_per_sec"] > 0
    assert not (tmp_path / "store").exists()


def test_wheel_ships_the_kernel_sources(tmp_path):
    """A wheel built from a copy of the tree lists every CUDA source of
    the port, and the installed package finds them beside itself and
    builds its kernels into a per-user cache directory (not next to
    site-packages). Built in ``tmp_path``: setuptools writes ``build/``
    and ``*.egg-info`` where it builds."""
    import json
    import os
    import shutil
    import subprocess
    import sys
    import zipfile
    src = tmp_path / "tree"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(ROOT / name, src / name)
    shutil.copytree(ROOT / "src", src / "src", ignore=shutil.ignore_patterns(
        "__pycache__", "*.egg-info"))
    out = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "--no-index", "--no-cache-dir", "-w",
         str(tmp_path / "dist"), str(src)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    want = {f"repro_torch/csrc/{p.name}" for p in csrc.iterdir()
            if p.suffix in (".cu", ".cuh")}
    assert len(want) >= 6 and want <= names
    site = tmp_path / "site"
    zipfile.ZipFile(wheel).extractall(site)
    env = dict(os.environ, PYTHONPATH=str(site),
               XDG_CACHE_HOME=str(tmp_path / "cache"))
    out = subprocess.run(
        [sys.executable, "-c", "import json; from repro_torch.kernels "
         "import ops; print(ops.BUILD_DIR); print(json.dumps(sorted(p.name "
         "for p in ops.CSRC.iterdir())))"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    build_dir, listed = out.stdout.splitlines()
    assert build_dir == str(tmp_path / "cache" / "repro_torch" / "kernels")
    assert sorted(n.split("/")[-1] for n in want) == json.loads(listed)
    # in a writable checkout the kernels keep building into its build/
    from repro_torch.kernels import ops
    if os.access(ROOT, os.W_OK):
        assert ops.BUILD_DIR == ROOT / "build" / "kernels"
