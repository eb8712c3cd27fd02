"""The kernel builder of the port (dupl_tpu_torch/kernels/build.py): a
missing toolkit or a failed compile raises; nothing falls back.  And the
port's rule that it never imports JAX."""

import pkgutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

import dupl_tpu_torch

from dupl_tpu_torch.kernels import build

torch.set_num_threads(2)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("exp_attention")


def test_failed_compile_raises_with_the_command(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_nvcc", lambda: "false")  # exits 1
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed") as ei:
        build.build("crf_apply")
    assert "sm_90a" in str(ei.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_serialised_wgmma_fails_the_build(monkeypatch, tmp_path):
    """A build whose ptxas notes that it serialised wgmma products raises
    with the note and keeps no library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\necho 'ptxas info    : (C7513) Potential Performance Loss: "
        "wgmma.mma_async instructions are serialized due to non wgmma "
        "instructions defining input registers' >&2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="serialised the wgmma") as ei:
        build.build("flash_attention")
    assert "C7513" in str(ei.value)
    assert not list((tmp_path / "build").iterdir())


def test_ptxas_usage_reads_the_kept_log(monkeypatch, tmp_path):
    """A build keeps nvcc's output beside the library, and ptxas_usage
    reads each entry function's registers and spills from its -v lines."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("""#!/bin/sh
while [ $# -gt 0 ]; do [ "$1" = -o ] && out="$2"; shift; done
cat >&2 <<'LOG'
ptxas info    : Compiling entry function '_Zk1' for 'sm_90a'
ptxas info    : Function properties for _Zk1
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Zk2' for 'sm_90a'
ptxas info    : Function properties for _Zk2
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
LOG
: > "$out"
""")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    assert build.ptxas_usage("par_propagate") == [("_Zk1", 168, 0, 0),
                                                  ("_Zk2", 128, 8, 4)]
    assert len(list((tmp_path / "build").glob("par_propagate-*.log"))) == 1


def test_one_nvcc_per_source_and_machine(monkeypatch, tmp_path):
    """Builders of one source that start together (the ranks of a node)
    run the compiler once: the others wait on the source's lock and load
    the first one's library; another source builds alongside."""
    nvcc = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    nvcc.write_text(f"""#!/bin/sh
while [ $# -gt 0 ]; do [ "$1" = -o ] && out="$2"; src="$1"; shift; done
echo "$src" >> {calls}
sleep 0.5
: > "$out"
""")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    names = ["par_propagate"] * 4 + ["crf_apply"]
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(build.build, names))
    assert len(set(paths[:4])) == 1 and paths[4] != paths[0]
    built = sorted(Path(line).name for line in calls.read_text().split())
    assert built == ["crf_apply.cu", "par_propagate.cu"]
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [paths[0].name, paths[0].with_suffix(".log").name, paths[4].name,
         paths[4].with_suffix(".log").name])


def test_library_name_follows_the_sources():
    """The cache key covers every source, header and flag."""
    src = build.CSRC / "exp_attention.cu"
    assert build._digest(src) == build._digest(src)
    assert build._digest(src) != build._digest(build.CSRC / "crf_apply.cu")
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == [
        "crf_apply", "crf_apply_bf16", "exp_attention", "exp_attention_bnhd",
        "exp_attention_bwd", "exp_attention_ones", "exp_rate",
        "flash_attention", "flash_attention_bwd", "par_affinity",
        "par_propagate"]
    # a shared header is part of every library's name
    assert (build.CSRC / "mma_bf16.cuh").exists()


def test_port_never_imports_jax():
    """Every module of dupl_tpu_torch, imported in a fresh interpreter,
    leaves behind no module of jax, flax or optax, none of the JAX package
    (``dupl_tpu``), no copy of its config loaded by file path, and no
    matplotlib (the card's machine may lack it; ``utils/tb.py`` imports a
    TensorBoard backend only when a writer is built)."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        dupl_tpu_torch.__path__, "dupl_tpu_torch."))
    for expected in ("dupl_tpu_torch.ops.par_cuda", "dupl_tpu_torch.config",
                     "dupl_tpu_torch.engine.train",
                     "dupl_tpu_torch.engine.optimizer",
                     "dupl_tpu_torch.ops.augment", "dupl_tpu_torch.ops.gmm",
                     "dupl_tpu_torch.data.pipeline",
                     "dupl_tpu_torch.data.voc", "dupl_tpu_torch.data.transforms",
                     "dupl_tpu_torch.utils.metrics", "dupl_tpu_torch.utils.device",
                     "dupl_tpu_torch.ops.crf_native",
                     "dupl_tpu_torch.engine.validate",
                     "dupl_tpu_torch.engine.eval_seg",
                     "dupl_tpu_torch.ops.experiments",
                     "dupl_tpu_torch.engine.checkpoint",
                     "dupl_tpu_torch.models.pretrained",
                     "dupl_tpu_torch.data.coco", "dupl_tpu_torch.data.records",
                     "dupl_tpu_torch.utils.logging",
                     "dupl_tpu_torch.utils.timing",
                     "dupl_tpu_torch.parallel.mesh",
                     "dupl_tpu_torch.parallel.data_parallel",
                     "dupl_tpu_torch.parallel.dryrun",
                     "dupl_tpu_torch.utils.tb", "dupl_tpu_torch.utils.flops",
                     "dupl_tpu_torch.utils.colormap"):
        assert expected in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = ('jax', 'jaxlib', 'flax', 'optax', 'dupl_tpu',\n"
            "       'matplotlib')\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m in bad or m.startswith(tuple(b + '.' for b in bad))\n"
            "             or m == 'dupl_tpu_torch._reference_config'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         cwd=Path(dupl_tpu_torch.__file__).parents[1]).stdout
    assert out.strip() == "[]", out


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/serve_torch.py",
                                    "tools/bench_train_torch.py",
                                    "tools/eval_seg_torch.py",
                                    "tools/infer_cam_torch.py",
                                    "tools/train_torch.py",
                                    "tools/exp_attn_experiment_torch.py",
                                    "tools/exp_attn_layout_experiment_torch.py",
                                    "tools/crf_apply_experiment_torch.py",
                                    "tools/exp_rate_experiment_torch.py",
                                    "tools/attn_fwd_timing_torch.py",
                                    "tools/crf_par_timing_torch.py",
                                    "tools/convert_ref_checkpoint_torch.py",
                                    "tools/pack_records_torch.py",
                                    "tools/gen_cls_labels_torch.py",
                                    "tools/bench_records_torch.py",
                                    "tools/crf_width_probe_torch.py",
                                    "tools/convert_test_seg_torch.py",
                                    "dupl_tpu_torch/engine/profile.py"])
def test_port_scripts_name_no_jax_module(script):
    """The port's scripts import nothing of jax, flax, optax, the JAX
    package or the JAX side's tree writers (``tools/make_fake_*``), by name
    or by file path."""
    import ast
    root = Path(dupl_tpu_torch.__file__).parents[1]
    tree = ast.parse((root / script).read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    bad = ("jax", "jaxlib", "flax", "optax", "dupl_tpu", "matplotlib")
    assert not [m for m in mods if m.split(".")[0] in bad], mods
    assert not [m for m in mods if "make_fake" in m], mods
    assert "spec_from_file_location" not in (root / script).read_text()


@pytest.mark.parametrize("script", ["tools/repro_voc_torch.sh",
                                    "tools/repro_coco_torch.sh"])
def test_port_shell_scripts_run_only_port_tools(script):
    """A _torch shell script runs no Python tool without ``_torch`` and
    imports nothing of the JAX package in its inline Python."""
    import re
    root = Path(dupl_tpu_torch.__file__).parents[1]
    text = (root / script).read_text()
    tools = re.findall(r"tools/(\w+)\.py", text)
    assert tools and all(t.endswith("_torch") for t in tools), tools
    assert not re.search(r"\b(jax|flax|dupl_tpu)(\.|\b)(?!_torch)", text
                         .replace("dupl_tpu_torch", "")), script
    assert "JAX_PLATFORMS" not in text


@pytest.mark.parametrize("test_file", ["tests/test_torch_corun.py",
                                       "tests/test_torch_corun_cli.py"])
def test_corun_helpers_import_no_jax(test_file, tmp_path):
    """The co-run tests take their recipe and tree from ``chip_smoke``'s
    ``corun_config`` and ``write_corun_tree``, which the card's phase 28
    runs too: in a fresh interpreter both helpers, run on the port's config
    module, import nothing of jax, flax, optax or the JAX package."""
    import ast
    root = Path(dupl_tpu_torch.__file__).parents[1]
    names = {a.name for node in ast.walk(ast.parse(
        (root / test_file).read_text()))
        if isinstance(node, ast.ImportFrom) and node.module == "chip_smoke"
        for a in node.names}
    assert {"corun_config", "write_corun_tree"} <= names, names
    code = ("import sys\n"
            "import chip_smoke\n"
            "from dupl_tpu_torch import config\n"
            "cfg = chip_smoke.corun_config(config, 60)\n"
            "assert (cfg.cam_iters, cfg.gmm_iters, cfg.max_iters) == "
            "(12, 24, 60)\n"
            f"chip_smoke.write_corun_tree({str(tmp_path)!r}, 2, 1)\n"
            "bad = ('jax', 'jaxlib', 'flax', 'optax', 'dupl_tpu')\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m in bad or m.startswith(tuple(b + '.' for b in bad))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         cwd=root).stdout
    assert out.strip() == "[]", out


def test_corun_tree_ties_a_colour_to_each_class(tmp_path):
    """``write_corun_tree`` paints every object in its class's colour of
    ``corun_colours`` (under its texture, the noise and the JPEG), whatever
    the seed: the colour nearest an object's mean is its class's, and the
    colours are far apart."""
    import numpy as np
    from PIL import Image

    from chip_smoke import corun_colours, write_corun_tree

    colours = corun_colours().astype(np.float64)
    assert np.array_equal(corun_colours(), corun_colours())
    fg = colours[1:]
    dist = np.sqrt(((fg[:, None] - fg[None]) ** 2).sum(-1))
    assert dist[~np.eye(len(fg), dtype=bool)].min() > 30
    for seed in (0, 1):
        root, lists = write_corun_tree(str(tmp_path / str(seed)), 8, 2,
                                       seed=seed)
        labels = np.load(f"{lists}/cls_labels_onehot.npy",
                         allow_pickle=True).item()
        names = open(f"{lists}/train_aug.txt").read().split()
        names += open(f"{lists}/val.txt").read().split()
        assert sorted(labels) == sorted(names) and len(names) == 10
        for name in names:
            img = np.asarray(Image.open(f"{root}/JPEGImages/{name}.jpg"),
                             np.float64)
            mask = np.asarray(Image.open(
                f"{root}/SegmentationClassAug/{name}.png"))
            present = [c for c in np.unique(mask) if 0 < c < 255]
            assert labels[name].nonzero()[0].tolist() == [
                c - 1 for c in present]
            for c in present:
                mean = img[mask == c].mean(0)
                nearest = np.sqrt(((fg - mean) ** 2).sum(-1)).argmin() + 1
                assert nearest == c, (seed, name, c, mean)
