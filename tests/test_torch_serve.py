"""Port parity for the whole serving slice: dupl_tpu_torch's
``make_serving_fn`` and ``InferenceSession`` against dupl_tpu's, on the same
weights (written by the JAX package) and the same images (CPU, float32),
plus the HTTP front and the batcher's shutdown race."""

import io
import json
import subprocess
import sys
import threading
import urllib.error
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
from dupl_tpu.engine.export import make_serving_fn as j_make_serving_fn
from dupl_tpu.engine.serve import InferenceSession as JInferenceSession
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu_torch.config import DataConfig, ModelConfig, voc_config
from dupl_tpu_torch.engine import serve as tserve
from dupl_tpu_torch.engine.export import make_serving_fn
from dupl_tpu_torch.models.convert import load_weights
from dupl_tpu_torch.models.network import DualStudent

torch.set_num_threads(2)

_MODEL = dict(backbone="test_tiny_patch16", compute_dtype="float32")
CROP = 64


def _cfgs():
    return (voc_config(model=ModelConfig(**_MODEL),
                       data=DataConfig(crop_size=CROP)),
            j_voc_config(model=JModelConfig(**_MODEL),
                         data=JDataConfig(crop_size=CROP)))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    _, jcfg = _cfgs()
    jmodel = JDualStudent(jcfg.model)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, CROP, CROP, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    ckpt.export_weights(path, params)
    return jmodel, params, path


def _images(n=2, seed=0):
    """Smooth colour fields with blocks: images with structure, so the CRF
    has edges to follow."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:CROP, 0:CROP] / CROP
    out = []
    for _ in range(n):
        img = np.stack([np.sin(6 * xx * rs.rand() + rs.rand() * 6),
                        np.cos(5 * yy * rs.rand() + rs.rand() * 6),
                        xx * yy], -1)
        y0, x0 = rs.randint(0, CROP // 2, 2)
        img[y0:y0 + 24, x0:x0 + 24] = rs.rand(3)
        out.append(np.clip(127.5 * (img + 1) + 10 * rs.randn(CROP, CROP, 3),
                           0, 255))
    return np.stack(out).astype(np.uint8)


@pytest.mark.parametrize("branch", [1, "ensemble"])
@pytest.mark.parametrize("crf", [True, False])
def test_serving_fn_matches_jax(weights, branch, crf):
    """uint8 in, uint8 labels out through MSC + flip, the branch pick or
    ensemble, and the fast CRF.  Labels at least 99.5% equal: fp32 on both
    sides, but argmax near-ties and the CRF's bf16 kernel entries may
    resolve differently where fp32 sums differ in order."""
    jmodel, params, path = weights
    cfg, jcfg = _cfgs()
    imgs = _images()
    want = np.asarray(jax.jit(j_make_serving_fn(jcfg, jmodel, branch=branch,
                                                crf=crf))(params, imgs))
    model = DualStudent(cfg.model)
    model.load_state_dict(load_weights(path))
    fn = make_serving_fn(cfg, model.eval(), branch=branch, crf=crf)
    got = fn(torch.from_numpy(imgs)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, CROP, CROP)
    assert (got == want).mean() >= 0.995
    assert len(np.unique(want)) > 1  # the comparison is not between constants


def test_session_from_weights_matches_jax(weights):
    """Both packages' sessions on the same .npz and native-size images."""
    _, _, path = weights
    cfg, jcfg = _cfgs()
    kw = dict(batch_size=2, scales=(1.0,), crf=False)
    session = tserve.InferenceSession.from_weights(cfg, path, device="cpu",
                                                   **kw)
    jsession = JInferenceSession.from_weights(jcfg, path, **kw)
    rs = np.random.RandomState(1)
    imgs = [rs.randint(0, 255, (50, 70, 3)).astype(np.uint8),
            rs.randint(0, 255, (90, 40, 3)).astype(np.uint8),
            rs.randint(0, 255, (64, 64, 3)).astype(np.uint8)]
    got, want = session.predict(imgs), jsession.predict(imgs)
    for g, w, img in zip(got, want, imgs):
        assert g.shape == img.shape[:2] and g.dtype == np.uint8
        assert (g == w).mean() >= 0.995
    assert session.meta["device"] == "cpu"


def _post(url, body, ctype, accept=None):
    headers = {"Content-Type": ctype, **({"Accept": accept} if accept else {})}
    req = urllib.request.Request(url, data=body, method="POST", headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.headers.get("Content-Type"), r.read()


def test_http_round_trip(weights):
    """The real tiny model behind the HTTP front: PNG and .npy bodies,
    /healthz, /metrics, and a 400 on an undecodable body."""
    from PIL import Image

    _, _, path = weights
    cfg, _ = _cfgs()
    session = tserve.InferenceSession.from_weights(
        cfg, path, device="cpu", batch_size=2, scales=(1.0,), crf=True)
    batcher = tserve.Batcher(session, max_delay_s=0.005)
    srv = tserve.make_http_server(batcher, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["crop_size"] == CROP
        img = _images(1)[0][:40, :56]
        buf = io.BytesIO()
        np.save(buf, img)
        ctype, body = _post(url + "/v1/segment", buf.getvalue(),
                            "application/x-npy", accept="application/x-npy")
        pred = np.load(io.BytesIO(body))
        assert ctype == "application/x-npy" and pred.shape == (40, 56)
        assert pred.max() < cfg.num_classes
        pbuf = io.BytesIO()
        Image.fromarray(img).save(pbuf, format="PNG")
        ctype, body = _post(url + "/v1/segment", pbuf.getvalue(), "image/png")
        out = Image.open(io.BytesIO(body))
        assert ctype == "image/png" and out.mode == "P" and out.size == (56, 40)
        np.testing.assert_array_equal(np.asarray(out), pred)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/v1/segment", b"not an image", "image/png")
        assert ei.value.code == 400
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            m = json.loads(r.read())
        assert m["responses_2xx"] >= 3 and m["responses_4xx"] == 1
        assert m["dispatches"] >= 1 and m["failed_dispatches"] == 0
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_http_server_queues_concurrent_connections():
    """Twenty clients connecting at once all complete the TCP handshake
    while the server is busy (not accepting): none waits out a SYN retry."""
    import socket

    s = tserve.InferenceSession(lambda b: b[..., 0], batch_size=1,
                                crop_size=8, num_classes=21)
    b = tserve.Batcher(s)
    srv = tserve.make_http_server(b, "127.0.0.1", 0)
    socks = []
    try:
        for _ in range(20):
            sock = socket.socket()
            socks.append(sock)
            sock.settimeout(0.5)
            sock.connect(srv.server_address)
    finally:
        for sock in socks:
            sock.close()
        srv.server_close()
        b.close()


def test_batcher_survives_future_failed_before_result():
    """A future failed by submit()/close() while its dispatch runs must not
    kill the worker when the dispatch later resolves it."""
    started, release = threading.Event(), threading.Event()

    def run(batch):
        started.set()
        release.wait(timeout=10)
        return np.zeros((batch.shape[0], 16, 16), np.uint8)

    s = tserve.InferenceSession(run, batch_size=1, crop_size=16,
                                num_classes=21)
    b = tserve.Batcher(s, max_delay_s=0.001)
    img = np.zeros((16, 16, 3), np.uint8)
    first = b.submit(img)
    assert started.wait(timeout=10)
    first.set_exception(RuntimeError("batcher closed"))  # the racing failer
    release.set()
    with pytest.raises(RuntimeError, match="batcher closed"):
        first.result(timeout=10)
    second = b.submit(img)          # the worker is still alive to answer it
    assert second.result(timeout=10).shape == (16, 16)
    b.close()


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dupl_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "dupl_tpu_torch.__path__, 'dupl_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 14, mods\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax'))\n"
        "assert not bad, bad\n"
        "assert 'dupl_tpu' not in sys.modules\n"
        "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
