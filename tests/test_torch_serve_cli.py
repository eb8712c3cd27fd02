"""The port's deployment pair on the command line, the counterpart of
``tests/test_serve_cli.py``: ``tools/export_model_torch.py --device cpu``
seals a tiny servable from a JAX-written ``.npz``, ``tools/serve_torch.py
--artifact ... --device cpu`` serves it over a real socket, and one POSTed
image gets back the labels of ``InferenceSession.from_weights`` on the same
``.npz``.  Then ``InferenceSession.from_artifact``'s refusals."""

import dataclasses
import io
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu.config import DataConfig as JDataConfig
from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.config import voc_config as j_voc_config
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu_torch.config import DataConfig, ModelConfig, voc_config
from dupl_tpu_torch.engine import export
from dupl_tpu_torch.engine.serve import InferenceSession
from dupl_tpu_torch.models.convert import load_weights
from dupl_tpu_torch.models.network import DualStudent

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODEL = dict(backbone="test_tiny_patch16", compute_dtype="float32")
CROP = 64


def _cfg():
    return voc_config(model=ModelConfig(**_MODEL),
                      data=DataConfig(crop_size=CROP))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg = j_voc_config(model=JModelConfig(**_MODEL),
                        data=JDataConfig(crop_size=CROP))
    params = JDualStudent(jcfg.model).init(
        jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    ckpt.export_weights(path, params)
    return path


def _env():
    return dict(os.environ, OMP_NUM_THREADS="2")


def test_export_then_serve_cli(weights, tmp_path):
    from PIL import Image

    art = str(tmp_path / "tiny.duplsrv")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "export_model_torch.py"),
         "--device", "cpu", "--weights", weights, "--out", art,
         "--backbone", "test_tiny_patch16", "--crop-size", str(CROP),
         "--batch-size", "2", "--branch", "1", "--scales", "1.0"],
        capture_output=True, text=True, timeout=600, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(art) and f"crop_size: {CROP}" in r.stdout

    # the server's stderr goes to a file: a full pipe would stall it
    log = tmp_path / "server.log"
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "serve_torch.py"),
             "--artifact", art, "--device", "cpu", "--port", "0"],
            stdout=subprocess.PIPE, stderr=err, text=True, env=_env(),
            cwd=REPO)
        try:
            line = ""
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                line = proc.stdout.readline()
                if "serving on" in line or proc.poll() is not None:
                    break
            assert "serving on" in line, log.read_text()[-2000:]
            url = line.split("serving on ")[1].split()[0]

            img = np.random.RandomState(0).randint(
                0, 255, (40, 56, 3)).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            req = urllib.request.Request(
                url + "/v1/segment", data=buf.getvalue(), method="POST",
                headers={"Content-Type": "image/png",
                         "Accept": "application/x-npy"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                got = np.load(io.BytesIO(resp.read()))
            proc.terminate()
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            proc.stdout.close()

    # the tool's config: the recipe's, with the backbone and crop replaced
    base = voc_config()
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model,
                                        backbone="test_tiny_patch16"),
        data=dataclasses.replace(base.data, crop_size=CROP))
    live = InferenceSession.from_weights(cfg, weights, device="cpu",
                                         batch_size=2, scales=(1.0,),
                                         branch=1, crf=True)
    want = live.predict([img])[0]
    assert got.shape == (40, 56) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_from_artifact_refusals(weights, tmp_path):
    """A pseudo-labeler, an unbaked program, and a program asked to serve on
    another device than it was sealed for are refused."""
    cfg = dataclasses.replace(_cfg(), cam_scales=(1.0,))
    model = DualStudent(cfg.model)
    model.load_state_dict(load_weights(weights))
    cases = {
        "pseudo_labeler": export.export_pseudo_labeler(
            cfg, model, batch_size=1, device="cpu"),
        "bake_params=False": export.export_serving(
            cfg, model, batch_size=1, scales=(1.0,), crf=False,
            device="cpu", bake_params=False),
    }
    for match, (exported, meta) in cases.items():
        path = str(tmp_path / "a.duplsrv")
        export.save_artifact(path, exported, meta)
        with pytest.raises(ValueError, match=match):
            InferenceSession.from_artifact(path, device="cpu")
    exported, meta = export.export_serving(cfg, model, batch_size=1,
                                           scales=(1.0,), crf=False,
                                           device="cpu")
    path = str(tmp_path / "b.duplsrv")
    export.save_artifact(path, exported, meta)
    with pytest.raises(ValueError, match="re-export"):
        InferenceSession.from_artifact(path, device="cuda")
    session = InferenceSession.from_artifact(path, device="cpu")
    assert session.meta["device"] == "cpu" and session.batch_size == 1
