"""The port's HTTP endpoint (decafnet_tpu_torch.serve) on a CPU service:
/healthz, /ground and /ground_batch answer as the service does (and /ground
as the JAX service does on the same weights), a bad body gets 400 and an
unknown path 404. Also service_from_logdir on an experiment directory and
the CLI's arguments."""

import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax

from decafnet_tpu.core import get_cfg_defaults as jax_defaults
from decafnet_tpu.core import update_eval_data as jax_update_eval_data
from decafnet_tpu.core import update_opt as jax_update_opt
from decafnet_tpu.models import make_model as jax_make_model
from decafnet_tpu.serve import GroundingService as JaxService
from decafnet_tpu_torch.models import save_pth
from decafnet_tpu_torch.serve import (GroundingService, main, make_handler,
                                      service_from_logdir)

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

CV, CS, CT = 32, 32, 24


def _small(cfg):
    m = cfg.model
    m.name = "iter"
    m.vid_net.in_dim = CV
    m.vid_net.embd_dim = 16
    m.vid_net.max_seq_len = 64
    m.vid_net.arch = (1, 0, 3)
    m.text_net.in_dim = CT
    m.text_net.embd_dim = 16
    m.text_net.n_layers = 1
    m.fusion.n_layers = 1
    m.sratio = 0.5
    m.sn = 8
    m.msf = True
    return jax_update_eval_data(jax_update_opt(cfg))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A CPU service of an experiment directory behind a server on a free
    port, in a thread; the JAX service on the same weights."""
    jcfg = _small(jax_defaults("grounder"))
    V, T, L = 1, 64, 8
    rng = np.random.RandomState(0)
    params = jax_make_model(jcfg).init(
        jax.random.PRNGKey(2), rng.randn(V, CV, T).astype(np.float32),
        rng.randn(V, CS, T).astype(np.float32), np.ones((V, T), bool),
        rng.randn(V, CT, L).astype(np.float32),
        rng.randn(V, CS).astype(np.float32), np.ones((V, L), bool),
        deterministic=True)["params"]
    params = jax.tree.map(np.asarray, params)

    logdir = tmp_path_factory.mktemp("torch_http_exp")
    (logdir / "models").mkdir()
    jcfg.dump_to_file(str(logdir / "opt.yaml"))
    save_pth(str(logdir / "models" / "last.pth"), params)
    service = service_from_logdir(str(logdir), "last", device="cpu")

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    yield service, url, JaxService(jcfg, params=params), str(logdir)
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _request(t, q, seed):
    rng = np.random.RandomState(seed)
    return dict(vid=rng.randn(CV, t).astype(np.float32),
                shallow_vid=rng.randn(CS, t).astype(np.float32),
                texts=[rng.randn(CT, int(n)).astype(np.float32)
                       for n in rng.randint(3, 9, q)],
                text_cls=rng.randn(q, CS).astype(np.float32),
                fps=30.0, clip_size=32, clip_stride=16)


def _as_json(req):
    return {k: ([x.tolist() for x in v] if k == "texts" else
                v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in req.items()}


def _call(url, path, body=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g["scores"]) == len(w["scores"]) > 0
        np.testing.assert_allclose(np.asarray(g["segments"]).reshape(-1, 2),
                                   np.asarray(w["segments"]).reshape(-1, 2),
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4, rtol=0)


def test_healthz(served):
    service, url, _, _ = served
    code, body = _call(url, "/healthz")
    assert code == 200 and body["status"] == "ok"
    assert body["device"] == "cpu" and body["device_name"] == "cpu"
    assert body["n_devices"] == torch.cuda.device_count()
    assert isinstance(body["phase_stats"], dict)


@pytest.mark.parametrize("t,q,seed", [(40, 3, 1), (100, 2, 2)])
def test_ground_equals_service_and_jax(served, t, q, seed):
    service, url, jax_service, _ = served
    req = _request(t, q, seed)
    code, body = _call(url, "/ground", _as_json(req))
    assert code == 200
    assert body["detections"] == service.ground(**req)
    _assert_same(body["detections"], jax_service.ground(**req))


def test_ground_batch_equals_ground_many(served, tmp_path):
    service, url, _, _ = served
    reqs = [_request(40, 3, 1), _request(57, 2, 4)]
    code, body = _call(url, "/ground_batch",
                       {"requests": [_as_json(r) for r in reqs]})
    assert code == 200
    assert body["detections_batch"] == service.ground_many(reqs)
    # the same request with its arrays in .npy / .npz files
    r = reqs[0]
    files = {}
    for k in ("vid", "shallow_vid", "text_cls"):
        files[f"{k}_path"] = str(tmp_path / f"{k}.npy")
        np.save(files[f"{k}_path"], r[k])
    files["texts_path"] = str(tmp_path / "texts.npz")
    np.savez(files["texts_path"], **{f"q{i}": x for i, x in enumerate(r["texts"])})
    code, body2 = _call(url, "/ground", files)
    assert code == 200
    _assert_same(body2["detections"], body["detections_batch"][0])


@pytest.mark.parametrize("path,body,raw", [
    ("/ground", {"vid": [[0.0]]}, None),               # missing fields
    ("/ground", None, b"{not json"),                   # not JSON
    ("/ground_batch", {"requests": [[1, 2]]}, None),   # not an object
    ("/ground_batch", {}, None),                       # no requests
])
def test_bad_body_gets_400(served, path, body, raw):
    _, url, _, _ = served
    code, reply = _call(url, path, body, raw)
    assert code == 400 and "error" in reply


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_unknown_path_gets_404(served, method):
    _, url, _, _ = served
    code, reply = _call(url, "/nowhere", {} if method == "POST" else None)
    assert code == 404 and "/nowhere" in reply["error"]


def test_service_from_logdir_loads_the_ema_weights(served):
    service, _, _, logdir = served
    assert service.device.type == "cpu"
    other = GroundingService(service.decoder.cfg,
                             checkpoint=os.path.join(logdir, "models", "last.pth"),
                             device="cpu")
    for a, b in zip(other.model.state_dict().values(),
                    service.model.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError, match="9-9.msgpack"):
        service_from_logdir(logdir, "9-9", device="cpu")


def test_cli_arguments(capsys):
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--name", "--ckpt", "--host", "--port", "--warmup", "--set",
                 "--device"):
        assert flag in out
