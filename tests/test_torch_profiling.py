"""The port's phase timer, trace, memory probe and live dashboard, on the
CPU, against the JAX package's ``utils/profiling.py`` and ``utils/monitor.py``.

- ``PhaseTimer`` prints the JAX lines for the same totals; ``memory_probe``
  on a CPU device logs the JAX line and gives None; ``trace`` writes a
  Chrome trace holding an ``annotate`` span, and nothing when disabled.
- ``write_dashboard`` writes JAX's ``dashboard.html`` byte for byte and the
  config; ``serve`` answers on loopback; ``maybe_serve`` on a taken port
  falls back to the file with a note, as JAX does.
- Each series the page plots is a key of the port's train lines in
  ``metrics.jsonl`` (a trainer's stage on a tiny model) or of its AP line
  (``test_model``); the trainer writes the dashboard, serves it under
  ``MISC.USE_VISDOM`` and reports the ``[profile]`` fetch and step lines
  under ``CTRL.PROFILE_ANALYSIS``.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import glob
import json
import socket
import urllib.request

import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu.utils import monitor as jax_monitor
from feature_intertwiner_tpu.utils import profiling as jax_profiling
from feature_intertwiner_tpu_torch import build_model
from feature_intertwiner_tpu_torch.config import build_config
from feature_intertwiner_tpu_torch.data import synthetic
from feature_intertwiner_tpu_torch.data.loader import DetectionDataset, Loader
from feature_intertwiner_tpu_torch.evaluation import COCO
from feature_intertwiner_tpu_torch.train import workflow
from feature_intertwiner_tpu_torch.utils import monitor, profiling
from test_torch_trainer import TRAIN_OPTS


def test_phase_timer_prints_the_jax_lines():
    totals = {"step": 12.3456789, "fetch": 0.0012345, "forward": 3.0}
    counts = {"step": 7, "fetch": 8, "forward": 1}
    lines = {}
    for name, module in (("port", profiling), ("jax", jax_profiling)):
        timer = module.PhaseTimer()
        timer.totals, timer.counts = dict(totals), dict(counts)
        lines[name] = []
        timer.report(lines[name].append)
    assert lines["port"] == lines["jax"]
    assert lines["port"][0] == "[profile] fetch: total 0.001s over 8 calls (0.0002s avg)"

    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer.phase("fetch"):
            pass
    with timer.phase("step"):
        pass
    assert timer.counts == {"fetch": 3, "step": 1} and timer.totals["fetch"] >= 0
    off = profiling.PhaseTimer(enabled=False)
    with off.phase("fetch"):
        pass
    out = []
    off.report(out.append)
    assert off.totals == {} and out == []


def test_memory_probe_on_the_cpu_logs_the_jax_line():
    calls = []
    lines, jax_lines = [], []
    got = profiling.memory_probe(lambda x: calls.append(x * 2), torch.ones(4), iters=2,
                                 log_fn=lines.append, device="cpu")
    import jax.numpy as jnp

    want = jax_profiling.memory_probe(lambda x: x * 2, jnp.ones(4), iters=2,
                                      log_fn=jax_lines.append)
    assert got is None and want is None and len(calls) == 2
    assert lines == jax_lines == ["[memory] device memory stats unavailable on this backend"]


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    with profiling.trace(str(tmp_path / "off"), enabled=False):
        torch.ones(3).sum()
    assert not (tmp_path / "off").exists()
    with profiling.trace(str(tmp_path / "on")):
        with profiling.annotate("port_span"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = glob.glob(str(tmp_path / "on" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port_span" for e in events)


def test_dashboard_is_the_jax_page(tmp_path):
    cfg, jcfg = build_config(debug=True), jax_build_config(debug=True)
    path = monitor.write_dashboard(str(tmp_path / "port"), config=cfg)
    jpath = jax_monitor.write_dashboard(str(tmp_path / "jax"), config=jcfg)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    assert monitor.dashboard_html() == jax_monitor.dashboard_html()
    with open(tmp_path / "port" / "config.json") as f:
        dump = json.load(f)
    assert dump["TRAIN"]["BATCH_SIZE"] == cfg.TRAIN.BATCH_SIZE
    assert dump["DATA"]["LOADER_WORKER_MODE"] == "thread"
    assert monitor.write_dashboard(str(tmp_path / "bare")).endswith("dashboard.html")
    assert not (tmp_path / "bare" / "config.json").exists()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_and_a_taken_port(tmp_path, capsys):
    (tmp_path / "dashboard.html").write_text("<html>ok</html>")
    srv = monitor.serve(str(tmp_path), port=0)
    try:
        host, port = srv.server_address[:2]
        assert host == "127.0.0.1"
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/dashboard.html", timeout=5).read()
        assert body == b"<html>ok</html>"
        cfg = build_config(debug=True)
        cfg.MISC.USE_VISDOM = True
        cfg.MISC.VIS.PORT = port
        assert monitor.maybe_serve(cfg, str(tmp_path)) is None
        assert f"[monitor] port {port} unavailable" in capsys.readouterr().out
        cfg.MISC.USE_VISDOM = False
        assert monitor.maybe_serve(cfg, str(tmp_path)) is None
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One 'heads' epoch of 2 steps of a tiny model under
    ``CTRL.PROFILE_ANALYSIS`` and ``MISC.USE_VISDOM``; the page fetched
    over HTTP while the trainer serves it."""
    folder = tmp_path_factory.mktemp("monitored")
    cfg = build_config(opts=TRAIN_OPTS + ["TRAIN.SCHEDULE", "[1, 0, 0]", "TRAIN.DO_VALIDATION",
                                          "False", "TRAIN.KEEP_CHECKPOINTS", "1",
                                          "CTRL.PROFILE_ANALYSIS", "True",
                                          "MISC.USE_VISDOM", "True", "CTRL.SHOW_INTERVAL", "1"])
    cfg.MISC.VIS.PORT = _free_port()
    cfg.MISC.RESULT_FOLDER = str(folder)
    cfg.MISC.LOG_FILE = str(folder / "log.txt")
    data = synthetic.generate(num_images=4, size=(96, 128), seed=1, max_instances=3)
    loader = Loader(DetectionDataset(data, cfg, augment=True, seed=cfg.MISC.SEED), batch_size=2,
                    seed=cfg.MISC.SEED)
    trainer = workflow.Trainer(build_model(cfg, device="cpu", seed=0), cfg).resume()
    try:
        workflow.train_model(trainer, loader, "heads")
        url = f"http://127.0.0.1:{cfg.MISC.VIS.PORT}"
        page = urllib.request.urlopen(url + "/dashboard.html", timeout=5).read()
        served = urllib.request.urlopen(url + "/metrics.jsonl", timeout=5).read()
    finally:
        trainer._monitor.shutdown()
        trainer._monitor.server_close()
    return folder, page, served


def test_trainer_serves_the_dashboard_and_reports_the_phases(trained):
    folder, page, served = trained
    assert page == monitor.dashboard_html().encode()
    assert served == (folder / "metrics.jsonl").read_bytes()
    log = (folder / "log.txt").read_text().splitlines()
    for name in ("fetch", "step"):
        lines = [line for line in log if line.startswith(f"[profile] {name}: ")]
        assert [line.split(" over ")[1].split(" calls")[0] for line in lines] == ["1", "2"]


def test_every_plotted_series_is_a_key_of_the_ports_lines(trained, tmp_path, monkeypatch):
    """The loss panel, the status panel and the table read the train lines;
    the AP panel reads the evaluation's AP line."""
    folder, _, _ = trained
    with open(folder / "metrics.jsonl") as f:
        train = [json.loads(line) for line in f]
    assert len(train) == 2
    for rec in train:
        missing = [k for k, *_ in monitor._SERIES] + ["epoch", "iter", "lr", "time"]
        assert [k for k in missing if k not in rec] == []
        assert all(np.isfinite(rec[k]) for k, *_ in monitor._SERIES)

    # test_model's AP line, on detections equal to the ground truth
    data = synthetic.generate(num_images=2, size=(64, 80), seed=2, max_instances=2)
    cfg = build_config(opts=["DATASET.NUM_CLASSES", "4"])
    cfg.MISC.RESULT_FOLDER = str(tmp_path)
    cfg.MISC.LOG_FILE = str(tmp_path / "log.txt")

    def exact(model, cfg_, dataset, image_ids, eval_masks, **kw):
        for i in image_ids:
            boxes = np.asarray([[y, x, y + h, x + w] for x, y, w, h in dataset.boxes[i]],
                               np.int32)
            yield i, dataset.images[i], boxes, dataset.class_ids[i], \
                np.ones(len(boxes), np.float32), [None] * len(boxes)

    monkeypatch.setattr(workflow, "_detect_images", exact)
    stats = workflow.test_model(None, cfg, data, COCO(dataset=data.coco_dataset()))
    assert stats[0] == pytest.approx(1.0)
    with open(tmp_path / "metrics.jsonl") as f:
        ap = [json.loads(line) for line in f if "AP" in json.loads(line)]
    assert len(ap) == 1 and all(k in ap[0] for k, *_ in monitor._AP_SERIES)
