"""Spans inside the port's train and decode steps (``obs.recorder``).

On the CPU, a tiny dense config: a ``CodedTrainer`` step and a decode
cell's step under ``recording()`` give the span tree the benchmark's
metrics read (every child's parent, each step's unit, one
``attn.flash_bwd`` and one ``attn.decode_row`` a layer a step), the
JSONL round trip carries the new fields, the state a step leaves is bit
for bit the same with a recorder installed and without, and with none
installed the steps record nothing and every total reads 0.  A span opened on
a thread with no open span of its own (autograd's backward thread on
the card) takes the span its opener waits in as its parent.  The card's
test (marked ``gpu``) runs both steps with their device times:

    python -m pytest -q -m gpu tests/test_torch_obs_spans.py
"""
import functools
import io
import threading
import warnings

import numpy as np
import pytest
import torch

from repro_torch._device import generator
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import pipeline as pdata
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.obs import recorder as precorder
from repro_torch.obs import report as preport
from repro_torch.optim import adamw
from repro_torch.runtime import CodedStepConfig, CodedTrainer

CPU = "cpu"
LAYERS = 2
CFG = ModelConfig(name="t", family="dense", num_layers=LAYERS, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=257,
                  flash_block_kv=16, remat="full",
                  compute_dtype="float32", param_dtype="float32")
STEP_CHILDREN = {"coded.batch", "coded.mask", "coded.coefficients",
                 "coded.to_device", "train.forward_backward", "optim.adamw"}
SPAN_NAMES = STEP_CHILDREN | {"coded.step", "attn.flash_bwd", "decode.step",
                              "attn.decode_row"}
MASKS = [np.array(m, bool) for m in ([1, 1, 1, 1], [0, 1, 1, 0])]


def _train(steps_run, device=CPU, record=False):
    """(recorder or None, model, opt state, losses) of ``steps_run`` coded
    steps from one seeded state."""
    model = api.init_params(CFG, generator(5, device), trainable=True)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    opt = adamw.init(opt_cfg, model)
    tr = CodedTrainer(CFG, pdata.DataConfig(CFG.vocab_size, 16, 4),
                      CodedStepConfig(n_workers=4, c=2, unique_batch=4),
                      opt_cfg, alive_fn=lambda s: MASKS[s % 2])
    rec = precorder.Recorder() if record else None
    losses = []
    with precorder.recording(rec) if record else _nothing():
        for s in range(steps_run):
            model, opt, m = tr.run_step(model, opt, s)
            losses.append(m["loss"])
    return rec, model, opt, losses


def _decode(steps_run, device=CPU, record=False):
    """(recorder or None, each step's logits, the cache) of
    ``steps_run`` greedy steps of the decode cell."""
    b, s = 2, 16
    cell = steps.build_decode_cell(CFG, ShapeConfig("d", "decode", s, b),
                                   device=device)
    model = api.init_params(CFG, generator(7, device))
    cache = api.init_cache(CFG, b, s, "float32", device)
    tok = torch.randint(0, CFG.vocab_size, (b, 1),
                        generator=generator(8, device), device=device)
    rec = precorder.Recorder() if record else None
    out = []
    with precorder.recording(rec) if record else _nothing():
        for i in range(steps_run):
            logits, cache = cell.fn(model, cache, tok, 4 + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            out.append(logits)
    return rec, out, cache


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _by_id(events):
    return {e.span_id: e for e in events if e.kind == "span"}


def _children(events, parent):
    return [e for e in events if e.kind == "span"
            and e.parent == parent.span_id]


def _read(path):
    """A span total by path, as the benchmark's harness resolves a
    counter: attribute by attribute from ``SPANS``, then ``int()``."""
    return int(functools.reduce(getattr, path.split("."), precorder.SPANS))


def _totals():
    return {n: tuple(_read(f"{n}.{leaf}")
                     for leaf in precorder.SpanPaths.LEAVES)
            for n in SPAN_NAMES}


# --------------------------------------------------------------------------
# The span tree
# --------------------------------------------------------------------------

def test_coded_step_span_tree():
    rec, *_ = _train(2, record=True)
    events = rec.events()
    roots = [e for e in events if e.name == "coded.step"]
    assert [r.unit for r in roots] == [0, 1]
    for r in roots:
        assert r.parent is None
        f = r.field_dict()
        assert f == {"rows": 8, "tokens": 8 * 16}
        kids = _children(events, r)
        assert sorted(k.name for k in kids) == sorted(STEP_CHILDREN)
        assert all(k.unit == r.unit for k in kids)
        (fb,) = [k for k in kids if k.name == "train.forward_backward"]
        bwd = _children(events, fb)
        assert [k.name for k in bwd] == ["attn.flash_bwd"] * LAYERS
        assert all(k.unit == r.unit for k in bwd)
        # a child lies inside its parent on the host's clock
        for k in kids + bwd:
            up = _by_id(events)[k.parent]
            assert up.ts <= k.ts and k.ts + k.dur <= up.ts + up.dur
    # no span off the tree, and no device times on the CPU
    assert {e.name for e in events} == {"coded.step", "attn.flash_bwd"} \
        | STEP_CHILDREN
    assert all(e.dev_start is None for e in events)
    assert len({e.span_id for e in events}) == len(events)


def test_decode_step_span_tree():
    rec, *_ = _decode(3, record=True)
    events = rec.events()
    roots = [e for e in events if e.name == "decode.step"]
    assert [r.unit for r in roots] == [0, 1, 2]
    assert [r.field_dict()["position"] for r in roots] == [4, 5, 6]
    for r in roots:
        kids = _children(events, r)
        assert [k.name for k in kids] == ["attn.decode_row"] * LAYERS
        assert all(k.unit == r.unit for k in kids)
    assert len(events) == 3 * (1 + LAYERS)


def test_a_span_on_another_thread_takes_the_waiting_span_as_parent():
    """Autograd's backward thread on the card opens ``attn.flash_bwd``
    while the caller waits inside ``train.forward_backward``."""
    with precorder.recording() as rec:
        with precorder.span("coded.step", unit=9):
            with precorder.span("train.forward_backward"):
                def backward():
                    with precorder.span("attn.flash_bwd"):
                        with precorder.span("inner"):
                            pass
                t = threading.Thread(target=backward)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
    ev = {e.name: e for e in rec.events()}
    assert ev["attn.flash_bwd"].parent == ev["train.forward_backward"].span_id
    assert ev["inner"].parent == ev["attn.flash_bwd"].span_id
    assert {e.unit for e in ev.values()} == {9}


# --------------------------------------------------------------------------
# JSONL, device times and totals
# --------------------------------------------------------------------------

def test_jsonl_round_trip_of_the_span_fields():
    rec, *_ = _decode(2, record=True)
    rec._append(precorder.Event(ts=1.0, kind="span", name="timed", dur=0.5,
                                span_id=99, parent=0, unit=1,
                                dev_start=0.25, dev_end=0.75))
    buf = io.StringIO()
    n = rec.export_jsonl(buf)
    lines = buf.getvalue().splitlines()
    assert n == len(lines) == 2 * (1 + LAYERS) + 1
    back = precorder.parse_jsonl(lines)
    assert back == rec.events()
    assert '"dev_start":0.25' in lines[-1] and '"unit":1' in lines[-1]
    assert back[-1].dev_dur == 0.5
    # a plain event keeps the line it had
    plain = precorder.Event(ts=0.5, kind="mark", name="m")
    assert plain.to_json() == ('{"dur":null,"fields":{},"kind":"mark",'
                               '"name":"m","ts":0.5}')


class _FakeCudaEvent:
    """A CUDA event's read side, at a fixed time in ms."""

    def __init__(self, ms):
        self.ms, self.waited = ms, False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_device_times_are_read_after_the_work():
    ev = precorder.Event(ts=0.0, kind="span", name="x", dur=1e-3,
                         span_id=0)
    epoch, start, end = (_FakeCudaEvent(ms) for ms in (0.0, 2.0, 5.5))
    rec = precorder.Recorder()
    rec._append(precorder._OnDevice(ev, epoch, start, end))
    assert len(rec) == 1 and not end.waited
    with precorder.recording(rec):
        assert _read("x.count") == 1 and end.waited
        assert _read("x.host_ns") == 1_000_000
        assert _read("x.device_ns") == 3_500_000
    (got,) = rec.events()
    assert got.dev_start == pytest.approx(2e-3)
    assert got.dev_end == pytest.approx(5.5e-3)
    assert _read("x.count") == 0


def test_span_totals_read_by_path():
    assert set(_totals().values()) == {(0, 0, 0)}
    with precorder.recording() as rec:
        _train(1)
        _decode(2)
        moved = _totals()
    spans = rec.events("span")
    assert moved["coded.step"][0] == 1
    assert moved["attn.flash_bwd"][0] == LAYERS
    assert moved["attn.decode_row"][0] == 2 * LAYERS
    assert all(m[1] > 0 and m[2] == 0 for m in moved.values())
    for n in SPAN_NAMES:
        mine = [e for e in spans if e.name == n]
        assert moved[n][:2] == (len(mine),
                                round(sum(e.dur for e in mine) * 1e9))
    assert set(_totals().values()) == {(0, 0, 0)}


def test_report_gives_host_and_device_totals_and_self_time():
    ev = precorder.Event
    events = [
        ev(ts=0.0, kind="span", name="step", dur=1.0, span_id=0, unit=0,
           dev_start=0.0, dev_end=2.0),
        ev(ts=0.1, kind="span", name="fb", dur=0.5, span_id=1, parent=0,
           unit=0, dev_start=0.1, dev_end=1.5),
        ev(ts=0.2, kind="span", name="bwd", dur=0.2, span_id=2, parent=1,
           unit=0, dev_start=0.5, dev_end=1.0),
        ev(ts=0.3, kind="span", name="bwd", dur=0.2, span_id=3, parent=1,
           unit=0, dev_start=0.9, dev_end=1.2),
        ev(ts=0.7, kind="span", name="host_part", dur=0.1, span_id=4,
           parent=0, unit=0),
        ev(ts=2.0, kind="span", name="replan", dur=0.05),
    ]
    table = preport.span_table(events)
    assert table["step"]["host_self"] == pytest.approx(1.0 - 0.5 - 0.1)
    assert table["step"]["device_self"] == pytest.approx(2.0 - 1.4)
    # the two backward spans overlap on the device: their union counts
    assert table["fb"]["host_self"] == pytest.approx(0.5 - 0.3)
    assert table["fb"]["device_self"] == pytest.approx(1.4 - 0.7)
    assert table["bwd"]["n"] == 2
    assert table["bwd"]["device"] == pytest.approx(0.8)
    assert table["host_part"]["device"] is None
    assert table["replan"]["host_self"] == pytest.approx(0.05)
    text = preport.render_report(events)
    line = next(ln for ln in text.splitlines()
                if ln.strip().startswith("fb "))
    assert "host   500.00 ms self   200.00 ms" in line
    assert "device  1400.00 ms self   700.00 ms" in line


# --------------------------------------------------------------------------
# The recorder changes nothing the steps compute; without one, nothing
# --------------------------------------------------------------------------

def test_state_is_bit_identical_with_and_without_a_recorder():
    rec, m1, o1, l1 = _train(2, record=True)
    none, m0, o0, l0 = _train(2)
    assert none is None and len(rec) > 0
    assert all(torch.equal(a, b) for a, b in zip(l1, l0))
    for (n, p1), (_, p0) in zip(m1.named_parameters(),
                                m0.named_parameters()):
        assert torch.equal(p1, p0), n
        assert torch.equal(o1.mu[n], o0.mu[n]), n
        assert torch.equal(o1.nu[n], o0.nu[n]), n
    _, g1, c1 = _decode(3, record=True)
    _, g0, c0 = _decode(3)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))
    assert all(torch.equal(a, b) for a, b in zip(c1, c0))


def test_without_a_recorder_nothing_is_recorded(monkeypatch):
    assert precorder.active() is None
    assert precorder.span("coded.step", unit=0) is precorder.NULL_SPAN

    def refuse(*a, **k):
        raise AssertionError("a span without a recorder")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(precorder, "_Span", refuse)
    _train(2)
    _decode(2)
    assert set(_totals().values()) == {(0, 0, 0)}


@pytest.mark.gpu
def test_device_spans_on_the_card():
    """Both steps on the card: the backward's spans, on autograd's
    thread, under ``train.forward_backward``; every child's device time
    within its parent's; the same host-device synchronisations with a
    recorder installed as without."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = "cuda"
    syncs = []
    # the first pass builds the kernels and spends the warnings given
    # once a process
    for record in (False, False, True):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = (_train(2, dev, record), _decode(3, dev, record))
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append(sorted(str(w.message) for w in caught))
    assert syncs[1] == syncs[2], syncs
    (rec, *_), (drec, *_) = out
    torch.cuda.synchronize()
    on_device = {"coded.step", "train.forward_backward", "attn.flash_bwd",
                 "optim.adamw", "decode.step", "attn.decode_row"}
    for r in (rec, drec):
        events = r.events()
        by_id = _by_id(events)
        timed = [e for e in events if e.dev_start is not None]
        assert {e.name for e in timed} == {e.name for e in events} \
            & on_device
        for e in timed:
            up = by_id.get(e.parent)
            if up is not None and up.dev_start is not None:
                assert up.dev_start <= e.dev_start <= e.dev_end \
                    <= up.dev_end + 1e-9, (e, up)
    events = rec.events()
    fbs = [e for e in events if e.name == "train.forward_backward"]
    for fb in fbs:
        assert [k.name for k in _children(events, fb)] == \
            ["attn.flash_bwd"] * LAYERS
