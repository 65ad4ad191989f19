"""The port's flight recorder against the JAX package's, on the CPU.

* The copies: ``parse_profile_steps``, the sink's records and validation
  errors (corrupted lines, missing fields, unknown kinds), the Chrome
  export and the report's summary text are the JAX package's on the same
  records; the report CLI's exit codes and Chrome file too.
* The ``Telemetry`` object: disabled, it reads no clock; its profiler
  window (``torch.profiler``) writes a Chrome trace and names the file in
  the ``profile`` stop event.
* Training: telemetry on and off give bit-identical losses and the same
  number of metric fetches (events are built from what the flush already
  fetched); the ``train_step``/``flush``/``span`` events of the port's
  Trainer and the JAX Trainer over the same steps have the same kinds,
  steps and keys.
* Serving: the paged engine's request and wave events under churn (chunked
  prefill, preemption, n-gram drafts) are the JAX engine's, event for
  event (the port's ``dense`` oracle against the JAX ``xla`` backend, f32
  compute, as ``tests/test_torch_paged.py`` holds their tokens); telemetry
  leaves the tokens as they were; the stats row's ``supervisor_*`` keys
  come from a stability source as in JAX.
* The CLIs on the CPU: the train launcher with ``--supervise --ckpt-dir
  --fault-plan --telemetry --profile-steps``, the serve launcher with
  ``--telemetry``, the report reader.
"""
from __future__ import annotations

import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ServeConfig as JServe
from repro.configs.base import TrainConfig as JTrain
from repro.core.precision import QuantPolicy as JPolicy
from repro.launch.mesh import make_test_mesh
from repro.models import build as jax_build
from repro.models.params import init_params as jax_init_params
from repro.serve import make_serve_engine as jax_engine
from repro.telemetry import Telemetry as JTelemetry
from repro.telemetry import parse_profile_steps as jax_parse
from repro.telemetry import report as jax_report
from repro.telemetry import to_chrome_trace as jax_chrome
from repro.telemetry import validate_file as jax_validate
from repro.train import Trainer as JTrainer
from repro.train import init_train_state as jax_init_state
from repro.train import make_train_setup as jax_setup
from repro.train import make_train_step as jax_step
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig, ServeConfig, TrainConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.data import BigramLM
from repro_torch.models import build
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import make_serve_engine
from repro_torch.telemetry import (SCHEMA_VERSION, Telemetry, parse_profile_steps,
                                   to_chrome_trace, validate_file)
from repro_torch.telemetry import report as port_report
from repro_torch.train import Trainer, init_train_state, make_train_setup, make_train_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "smollm-360m"
MODE = "int8_switchback"


# ---------------------------------------------------------------------------
# the copies: sink, validation, Chrome export, report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["3:7", "1:1", None, "", "7:3", "abc", "-1:2"])
def test_parse_profile_steps_matches_jax(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return str(e)
    assert outcome(parse_profile_steps) == outcome(jax_parse)


def _write(Tele, path):
    """The same records through either package's Telemetry, at fixed times."""
    with Tele(path, program="test", meta={"arch": "x"}) as t:
        t.emit("train_step", ts=10.0, step=0, loss=1.25, **{"qh/mlp/w_absmax": 0.5})
        t.emit_span("flush", 10.0, 0.5, step=0, n_steps=1)
        t.emit("request", ts=11.0, uid=3, event="submitted", prompt_len=4)
        t.emit("anomaly", ts=12.0, step=2, anomaly="nonfinite", detail="loss=nan")
        t.emit("rewind", ts=12.5, step=2, restored_step=0, skipped=3, attempt=1)
        t.emit("wave", ts=13.0, wave=0, mode="decode", dur_s=0.01, slots=2)
        t.emit("serve_stats", ts=14.0, new_tokens=8, tokens_per_s=80.0, supervisor_rewinds=1)
    with open(path, "a") as f:
        f.write("{not json\n")
        f.write(json.dumps({"ts": 15.0, "kind": "rewind", "step": 3}) + "\n")
        f.write(json.dumps({"ts": 16.0, "kind": "span", "name": "x", "dur_s": -1}) + "\n")
        f.write(json.dumps({"ts": 17.0, "kind": "future_thing"}) + "\n")


def _records(path):
    out = []
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            out.append({k: v for k, v in r.items() if not (r["kind"] == "meta" and k == "ts")})
    return out


def test_sink_records_and_validation_match_jax(tmp_path):
    jp, tp = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    _write(JTelemetry, jp)
    _write(Telemetry, tp)
    assert _records(tp) == _records(jp)
    assert _records(tp)[0] == {"kind": "meta", "schema": SCHEMA_VERSION, "program": "test",
                               "arch": "x"}
    errs = validate_file(tp)
    assert errs == jax_validate(jp) and len(errs) == 4


def test_chrome_export_and_summary_match_jax(tmp_path):
    jp, tp = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    for Tele, p in ((JTelemetry, jp), (Telemetry, tp)):
        with Tele(p, program="train") as t:
            for i in range(3):
                t.emit("train_step", ts=1.0 + i, step=i, loss=3.0 - i, dt=0.01 * (i + 1),
                       **{"qh/mlp/w_absmax": 0.5 + i})
            t.emit("anomaly", ts=5.0, step=2, anomaly="nonfinite", detail="loss=nan")
            t.emit("rewind", ts=5.5, step=2, restored_step=0, skipped=1, attempt=1)
            for uid in (0, 1):
                for ev in ("submitted", "admitted", "prefill_chunk", "prefill_chunk",
                           "first_token", "finished"):
                    t.emit("request", ts=6.0 + uid, uid=uid, event=ev, ttft_s=0.02)
            t.emit("wave", ts=7.0, wave=0, mode="prefill", dur_s=0.02)
            t.emit_span("decode_wave", 7.0, 0.01, wave=1)
            t.emit("serve_stats", ts=8.0, new_tokens=4, tokens_per_s=40.0)
    jr, tr = port_report.load(jp), port_report.load(tp)
    for r in (jr[0], tr[0]):
        r["ts"] = 0.0
    assert to_chrome_trace(tr) == jax_chrome(jr)
    texts = []
    for summarize in (jax_report.summarize, port_report.summarize):
        buf = io.StringIO()
        summarize(tr, out=buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1] and "REWIND step 2 -> 0" in texts[1]


def test_report_cli_matches_jax(tmp_path, capsys):
    good, bad = str(tmp_path / "good.jsonl"), str(tmp_path / "bad.jsonl")
    with Telemetry(good, program="t") as t:
        t.emit("train_step", step=0, loss=2.0)
        t.emit_span("flush", 1.0, 0.25, step=0, n_steps=1)
    with open(bad, "w") as f:
        f.write("garbage\n")
    for argv in ([good, "--validate"], [bad, "--validate"], [good],
                 [good, "--chrome", str(tmp_path / "c.json")]):
        assert port_report.main(argv) == jax_report.main(argv)
    assert port_report.main([bad, "--validate"]) == 1
    with open(tmp_path / "c.json") as f:
        assert len(json.load(f)["traceEvents"]) == 3
    capsys.readouterr()


def test_disabled_telemetry_reads_no_clock(monkeypatch):
    import repro_torch.telemetry as T

    def no_clock():
        raise AssertionError("a disabled Telemetry read the clock")

    monkeypatch.setattr(T.time, "time", no_clock)
    t = Telemetry()
    assert not t.enabled and T.as_telemetry(None) is T.NULL
    t.emit("train_step", step=0, loss=1.0)
    t.emit_span("x", 0.0, 1.0)
    with t.span("y"):
        pass
    t.maybe_profile(0)
    t.close()


def test_profiler_window_writes_a_chrome_trace(tmp_path):
    path = str(tmp_path / "p.jsonl")
    t = Telemetry(path, profile_steps=(1, 2), profile_dir=str(tmp_path / "prof"),
                  program="test")
    x = torch.randn(64, 64)
    for step in range(5):
        t.maybe_profile(step)
        x = torch.tanh(x @ x)
    t.close()
    recs = port_report.load(path)
    prof = [(r["event"], r["step"]) for r in recs if r["kind"] == "profile"]
    assert prof == [("start", 1), ("stop", 3)]
    stop = [r for r in recs if r.get("event") == "stop"][0]
    with open(stop["file"]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("tanh" in n for n in names) and validate_file(path) == []


# ---------------------------------------------------------------------------
# training: no extra fetch, bit identity, the JAX Trainer's events
# ---------------------------------------------------------------------------

BATCH, SEQ, N = 2, 16, 6


@pytest.fixture(scope="module")
def train_parts():
    jcfg, tcfg = jax_reduced(ARCH), get_reduced_config(ARCH)
    jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=100, beta2=0.95,
              loss_scaler="none", quant_mode=MODE)
    opt, scaler = make_train_setup(TrainConfig(**kw))
    step = make_train_step(build(tcfg), QuantPolicy(MODE), ParallelConfig(remat="none"),
                           TrainConfig(**kw), opt, scaler)
    batches = [BigramLM(tcfg.vocab_size, seed=1000 + j, temperature=0.3).batch(BATCH, SEQ)
               for j in range(N)]
    np_params = jax.tree.map(np.asarray, jp)
    return dict(jcfg=jcfg, jp=jp, kw=kw, step=step, batches=batches,
                fresh=lambda: init_train_state(from_numpy_tree(np_params, device="cpu"),
                                               opt, scaler))


def _port_run(parts, tele):
    import repro_torch.train.trainer as TR
    real, n = TR.fetch_metrics, [0]

    def fetch(window):
        n[0] += 1
        return real(window)

    TR.fetch_metrics = fetch
    try:
        tr = Trainer(parts["step"], parts["fresh"](), log_every=2, telemetry=tele)
        tr.run(lambda i: {k: torch.from_numpy(v).long() for k, v in parts["batches"][i].items()},
               N)
    finally:
        TR.fetch_metrics = real
    return n[0], [h["loss"] for h in tr.history]


def test_telemetry_on_off_bit_identical_same_fetches(train_parts, tmp_path):
    path = str(tmp_path / "t.jsonl")
    tele = Telemetry(path, program="train")
    n_on, loss_on = _port_run(train_parts, tele)
    tele.close()
    n_off, loss_off = _port_run(train_parts, None)
    assert n_on == n_off == 4 and loss_on == loss_off
    assert validate_file(path) == []
    recs = port_report.load(path)
    steps = [r for r in recs if r["kind"] == "train_step"]
    assert len(steps) == N and any(k.startswith("qh/") for k in steps[0])
    assert any(k.endswith("/adamw_rms") for k in steps[0])
    assert {r["kind"] for r in recs} >= {"meta", "train_step", "flush", "span"}


def test_train_events_match_jax_trainer(train_parts, tmp_path):
    """The same N steps through the JAX Trainer and the port's, telemetry
    on: the same (kind, span name, step) sequence and train_step keys."""
    p = train_parts
    jtc = JTrain(**p["kw"])
    opt, scaler = jax_setup(jtc)
    jfn = jax.jit(jax_step(jax_build(p["jcfg"]), JPolicy(MODE), JParallel(remat="none"), jtc,
                           opt, scaler))
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    with JTelemetry(jpath, program="train") as tele:
        JTrainer(jfn, jax_init_state(p["jp"], opt, scaler), log_every=2, telemetry=tele).run(
            lambda i: {k: jnp.asarray(v) for k, v in p["batches"][i].items()}, N)
    with Telemetry(tpath, program="train") as tele:
        _port_run(p, tele)
    seqs = []
    for path in (jpath, tpath):
        recs = port_report.load(path)
        seqs.append(([(r["kind"], r.get("name", ""), r.get("step")) for r in recs[1:]],
                     [sorted(r) for r in recs if r["kind"] == "train_step"]))
    assert seqs[1] == seqs[0]


# ---------------------------------------------------------------------------
# serving: request and wave events, tokens, supervisor counters
# ---------------------------------------------------------------------------

def _serve_events(path):
    """(kind, event / mode / span name, uid, wave, slot) of every record
    but the meta header and the stats row; times and values left out."""
    return [(r["kind"], r.get("event") or r.get("mode") or r.get("name"), r.get("uid"),
             r.get("wave"), r.get("slot")) for r in port_report.load(path)
            if r["kind"] not in ("meta", "serve_stats")]


def _spec_prompts():
    pat = np.random.default_rng(0).integers(0, 256, size=3).tolist()
    return [(pat * 8)[:10 + i] for i in range(5)] + \
        [np.random.default_rng(9).integers(0, 256, size=n).tolist() for n in (13, 4)]


SERVE_CASES = {
    # repetitive prompts: drafts accepted, verify waves, chunked prefill
    "spec": (dict(max_len=48, num_blocks=14, spec_k=3), _spec_prompts, 10,
             {"verify", "verify_wave"}),
    # the JAX package's churn recording: a pool of 8 blocks preempts
    "preempt": (dict(max_len=32, num_blocks=8), lambda: [
        np.random.default_rng(8).integers(0, 256, size=10).tolist() for _ in range(2)], 20,
        {"preempted"}),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_paged_serve_events_match_jax(tmp_path, case):
    """Chunked prefill, preemption and n-gram drafts through 2 slots: the
    same events in the same order as the JAX engine, and the tokens of a
    telemetry-off run."""
    kw, prompts, new, needed = SERVE_CASES[case]
    prompts = prompts()
    jcfg, tcfg = jax_reduced(ARCH), get_reduced_config(ARCH)
    jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    scfg = dict(cache_mode="paged", quant_mode=MODE, max_batch=2, block_size=4,
                prefill_chunk_tokens=6, preemption="recompute", spec_mode="ngram",
                spec_min_ngram=1, **kw)
    jeng = jax_engine(jax_build(jcfg), JServe(**scfg), make_test_mesh((1, 1)),
                      policy=JPolicy(MODE, compute_dtype=jnp.float32, backend="xla"))
    teng = make_serve_engine(build(tcfg), ServeConfig(**scfg),
                             parallel=ParallelConfig(remat="none", attn_impl="dense"),
                             policy=QuantPolicy(MODE, compute_dtype=torch.float32), device="cpu")
    t_off, _ = teng.generate(tp, prompts, max_new_tokens=new)
    out = {}
    for tag, eng, params, Tele in (("jax", jeng, jp, JTelemetry), ("port", teng, tp, Telemetry)):
        path = str(tmp_path / f"{tag}.jsonl")
        eng.telemetry = Tele(path, program="serve")
        gens, stats = eng.generate(params, prompts, max_new_tokens=new)
        eng.telemetry.close()
        eng.telemetry = None
        assert validate_file(path) == []
        rows = [r for r in port_report.load(path) if r["kind"] == "serve_stats"]
        out[tag] = ([list(map(int, g)) for g in gens], _serve_events(path), sorted(rows[0]))
    assert out["port"] == out["jax"]
    assert out["port"][0] == t_off
    kinds = {e[1] for e in out["port"][1]}
    assert {"submitted", "admitted", "prefill_chunk", "first_token", "finished", "prefill",
            "decode", "prefill_wave", "decode_wave"} | needed <= kinds


def test_stats_surface_supervisor_counters_as_jax(tmp_path):
    from repro_torch.serve.engine import SUPERVISOR_KEYS
    eng = make_serve_engine(build(get_reduced_config(ARCH)),
                            ServeConfig(max_batch=2, max_len=32, quant_mode=MODE), device="cpu")
    params = eng.init_params(0)
    empty = eng.generate(params, [[1, 2, 3], [4, 5]], max_new_tokens=0)[1]
    full = eng.generate(params, [[1, 2, 3], [4, 5]], max_new_tokens=3)[1]
    assert set(empty) == set(full) and empty["supervisor_rewinds"] == 0
    eng.stability_source = {"rewinds": 3, "incidents": 2, "save_failures": 1}
    s = eng.generate(params, [[1, 2, 3]], max_new_tokens=2)[1]
    assert (s["supervisor_rewinds"], s["supervisor_incidents"], s["supervisor_save_failures"],
            s["supervisor_escalations"]) == (3, 2, 1, 0)

    class Src:                                         # report() duck type
        def report(self):
            return {"rewinds": 9, "escalations": 4, "other_junk": 1}

    class Stab:                                        # stability_report() duck type
        def stability_report(self):
            return {"supervisor": {k: i for i, k in enumerate(SUPERVISOR_KEYS)}}

    eng.stability_source = Src()
    s = eng._empty_stats()
    assert s["supervisor_rewinds"] == 9 and s["supervisor_escalations"] == 4
    eng.stability_source = Stab()
    assert [eng._empty_stats()[f"supervisor_{k}"] for k in SUPERVISOR_KEYS] == \
        list(range(len(SUPERVISOR_KEYS)))
    eng.stability_source = object()
    with pytest.raises(TypeError):
        eng._empty_stats()


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          env=env, timeout=300, cwd=ROOT)


def test_train_cli_supervised_with_telemetry(tmp_path):
    tele, ck = str(tmp_path / "run.jsonl"), str(tmp_path / "ck")
    out = _cli("repro_torch.launch.train", "--device", "cpu", "--steps", "12", "--batch", "2",
               "--seq", "16", "--quant-mode", MODE, "--ckpt-dir", ck, "--supervise",
               "--fault-plan", '[{"step": 7, "kind": "nan_grad"}]', "--telemetry", tele,
               "--profile-steps", "2:3", "--profile-dir", str(tmp_path / "prof"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "final loss:" in out.stdout and "'rewinds': 1" in out.stdout
    assert validate_file(tele) == []
    kinds = {r["kind"] for r in port_report.load(tele)}
    assert {"anomaly", "rewind", "checkpoint", "profile", "train_step"} <= kinds
    rep = _cli("repro_torch.telemetry.report", tele)
    assert rep.returncode == 0 and "REWIND step 7" in rep.stdout
    # a second run resumes from the newest checkpoint (step 10: every max(12 // 3,
    # 10) steps) and, asked for 10 steps, has nothing to do
    again = _cli("repro_torch.launch.train", "--device", "cpu", "--steps", "10", "--batch",
                 "2", "--seq", "16", "--quant-mode", MODE, "--ckpt-dir", ck)
    assert again.returncode == 0 and "nothing to do: resumed at step 10" in again.stdout


def test_serve_cli_with_telemetry(tmp_path):
    tele = str(tmp_path / "serve.jsonl")
    out = _cli("repro_torch.launch.serve", "--device", "cpu", "--quant-mode", MODE,
               "--cache-mode", "paged", "--block-size", "4", "--n-requests", "3",
               "--new-tokens", "4", "--max-len", "32", "--telemetry", tele)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[telemetry] events written" in out.stdout and validate_file(tele) == []
    recs = port_report.load(tele)
    assert sum(r["kind"] == "request" and r["event"] == "finished" for r in recs) == 3
    assert [r["kind"] for r in recs].count("serve_stats") == 1
