"""One run of one cell: build the system from the cell's configuration and
traffic files, warm up the cell's shapes, drive the closed loop for the
window, then check what the timed path produced against the reference
and read the metrics.

The model-specific arithmetic is the one the configuration file names.
A file may carry ``"reference": "<stem>"``: ``reference/<stem>.py`` then
gives the forward pass the checks hold the served tokens to
(``served_logits``, with ``reference/lm.py``'s contract), the FLOPs of a
decoded token (``token_flops``, which ``flops.token_flops`` hands on to)
and, optionally, ``PORT_FIELDS``: file keys set on the port's config
beside this module's own. A file without the key runs ``reference/lm.py``
(GQA, or MLA with softmax-routed experts) and ``flops``'s own count. A
stem with no file stops the run before set-up.

Everything the run measures comes from the benchmark's own spans around
the calls into the program (``Spans``), the program's cumulative
counters read at the window's edges, and a ``torch.profiler`` trace of
the whole window in a ``--trace 1`` run. The program under test is the
``repro_torch`` package, entered through ``StorInfer.submit``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
for _p in (HERE, HERE / "traffic", HERE / "reference"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch  # noqa: E402

import flops  # noqa: E402
import spans as SP  # noqa: E402
import weights as W  # noqa: E402
import world  # noqa: E402
from reference import minilm as ref_minilm  # noqa: E402
from reference.tokenizer import Tokenizer as RefTokenizer  # noqa: E402

# file key -> the port's ModelConfig field (the configuration file is what
# runs: its numbers are set on the port's registered config); a named
# reference's own PORT_FIELDS add to these for its files
PORT_FIELDS = {
    "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "vocab_size": "vocab_size", "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps", "norm_epsilon": "norm_eps",
    "n_routed_experts": "n_experts", "num_experts_per_tok":
    "experts_per_tok", "n_shared_experts": "n_shared_experts",
    "first_k_dense_replace": "first_dense_layers",
    "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_head_dim",
    "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
    "moe_capacity_factor": "moe_capacity_factor",
}


@dataclasses.dataclass
class Opts:
    root: Path
    workload: str
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    config: Optional[dict] = None     # tests: a configuration in place of
    traffic: Optional[dict] = None    # the cell's files
    limits: Optional[dict] = None
    fault: Optional[object] = None    # tests: fault(system) plants a fault
    control: bool = False             # also read the bf16 control


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "storbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


# where a configuration's ``reference`` stem is looked for, and the stem
# of a file without the key
REFERENCE = HERE / "reference"
DEFAULT_REFERENCE = "lm"
_references: Dict[Path, object] = {}


def reference(c: dict):
    """The reference module the configuration ``c`` names (loaded once a
    path): ``reference/<stem>.py`` for ``"reference": "<stem>"``, else
    ``reference/lm.py``. A missing file raises, naming its path."""
    stem = c.get("reference", DEFAULT_REFERENCE)
    path = REFERENCE / f"{stem}.py"
    if path not in _references:
        if not path.is_file():
            raise FileNotFoundError(
                f"configuration {c.get('name')!r} names the reference "
                f"{stem!r}, but {path} does not exist")
        _references[path] = load_module(path)
    return _references[path]


def port_config(c: dict):
    from repro_torch.configs import get_config
    fields = {**PORT_FIELDS, **getattr(reference(c), "PORT_FIELDS", {})}
    kw = {fields[k]: v for k, v in c.items() if k in fields}
    if "moe_intermediate_size" in c:
        kw.update(d_ff=c["moe_intermediate_size"],
                  d_ff_expert=c["moe_intermediate_size"],
                  d_ff_dense=c["intermediate_size"])
    else:
        kw["d_ff"] = c["intermediate_size"]
    if "kv_lora_rank" in c:
        kw["head_dim"] = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
        kw["q_lora_rank"] = c["q_lora_rank"] or 0
    else:
        kw["head_dim"] = flops.head_dim(c)
    return dataclasses.replace(get_config(c["port_arch"]), **kw)


def lm_layout(pcfg, root: Path):
    """The shapes of the port's params for ``pcfg``, read off its own
    ``init_model`` on the meta device once and kept in the checkout's
    ``build/storbench`` under a key of the config and the port's model
    and config sources (a layout the port changes is read again)."""
    import hashlib

    from repro_torch.models import model as M
    h = hashlib.sha256(json.dumps(dataclasses.asdict(pcfg), sort_keys=True,
                                  default=str).encode())
    src = Path(M.__file__).resolve().parents[1]
    for f in sorted(list((src / "models").glob("*.py"))
                    + list((src / "configs").glob("*.py"))):
        h.update(f.name.encode() + f.read_bytes())
    path = root / "build" / "storbench" / f"layout-{h.hexdigest()[:20]}.json"
    try:
        return W.layout_from_json(json.loads(path.read_text()))
    except (OSError, ValueError):
        pass
    layout = W.layout_of(M.init_model(pcfg, None, torch.float32, "meta"))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(W.layout_to_json(layout)))
    os.replace(tmp, path)
    return layout


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(o: Opts):
    """(the run's result: the contract's fields with ``checks`` last, the
    lines that say what the checks compared)."""
    bench = json.loads((o.root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == o.workload)
    centry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = o.config or json.loads((o.root / centry["file"]).read_text())
    reference(cfg)      # a missing reference stops the run here
    mix = o.traffic or json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = o.limits or json.loads(
        (HERE / "limits" / f"{o.workload}.json").read_text())
    sysc = cfg["system"]
    dev = torch.device(o.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sub = np.random.SeedSequence(int(o.seed)).generate_state(3)

    # -- the world and the weights, from the seed -------------------------
    from repro_torch.api import StorInfer, SystemCfg
    from repro_torch.core.embedder import EncoderCfg, MiniLMEncoder
    from repro_torch.core.store import PrecomputedStore
    from repro_torch.core.tokenizer import Tokenizer
    from repro_torch.models import model as M
    from repro_torch.serving.engine import BatchScheduler, Engine

    phases = [("imports", time.perf_counter())]
    questions, answers = world.store_pairs(
        sysc["store_profile"], sysc["store_rows"], int(sub[0]))
    ref_tok = RefTokenizer.from_texts(world.vocabulary_corpus(
        sysc["store_profile"], sysc["store_rows"]))
    port_tok = Tokenizer(ref_tok.words)
    phases.append(("world", time.perf_counter()))
    torch.zeros(1, device=dev)
    _sync(dev)
    phases.append(("device", time.perf_counter()))
    enc = sysc["minilm"]
    mini_w = W.fill(W.minilm_layout(ref_tok.vocab_size, enc["dim"],
                                    enc["layers"], enc["d_ff"]),
                    int(sub[1]), dev, embed_std=enc["embed_std"])
    phases.append(("minilm weights", time.perf_counter()))
    pcfg = port_config(cfg)
    layout = lm_layout(pcfg, o.root)
    phases.append(("lm layout", time.perf_counter()))
    lm_w = W.fill(layout, int(sub[2]), dev, dtype=getattr(torch, cfg["dtype"]))
    _sync(dev)
    phases.append(("lm weights", time.perf_counter()))
    # the store's embeddings: the reference encoder over every stored
    # question, kept in the store's dtype (the benchmark's input data)
    store_embs = ref_minilm.encode(mini_w, ref_tok, questions, enc["heads"],
                                   block=1024).to(getattr(torch,
                                                          sysc["emb_dtype"]))
    _sync(dev)
    phases.append(("store embeddings", time.perf_counter()))
    tmp = Path(tempfile.mkdtemp(prefix="storbench-store-"))
    try:
        with PrecomputedStore(tmp / "store", dim=enc["dim"],
                              emb_dtype=sysc["emb_dtype"]) as st:
            st.add_batch(store_embs.cpu().numpy(), questions, answers)
        phases.append(("store files", time.perf_counter()))
        embedder = MiniLMEncoder(
            port_tok, EncoderCfg(vocab_size=ref_tok.vocab_size,
                                 dim=enc["dim"], n_layers=enc["layers"],
                                 n_heads=enc["heads"], d_ff=enc["d_ff"]),
            params=mini_w, device=dev)
        engine = Engine(pcfg, lm_w, port_tok, max_len=sysc["max_len"],
                        chunk=sysc["chunk"])
        scfg = SystemCfg(embedder=embedder, index="flat",
                         index_kw={"use_kernel": True},
                         s_th_run=sysc["s_th_run"],
                         decode_slots=mix["decode_slots"],
                         device=str(dev), cache_index=False)
        scfg.runtime.add_misses = scfg.batched.add_misses = \
            sysc["write_back"]
        si = StorInfer.open(tmp / "store", scfg, engine=engine)
        streams = load_module(HERE / "traffic" / f"{mix['generator']}.py") \
            .streams(mix, questions, int(o.seed))
        phases.append(("system", time.perf_counter()))
        rec = SP.Spans()
        with SP.instrument(rec, si, BatchScheduler, trace=o.trace):
            _warm_up(si, engine, BatchScheduler, streams, mix, dev)
            rec.searches.clear()
            rec.chunks.clear()
            rec.finished.clear()
            tracer = SP.Tracer(dev) if o.trace else None
            if tracer is not None:
                tracer.start(rec)
            if o.fault is not None:
                o.fault(si)
            _sync(dev)
            setup_s = time.perf_counter() - o.t_start
            phases.append(("warm-up", time.perf_counter()))
            win = _window(si, rec, streams, o, dev, tracer)
        mem_peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0)
        si.close()
        del si, engine, embedder
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks, failed, attempted, notes, ctrl = _check(
            cfg, sysc, win, rec, questions, answers, store_embs, mini_w,
            lm_w, ref_tok, enc, limits, int(o.seed), dev, o.control)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ctx = SP.Context(cfg=cfg, mix=mix, rec=rec, win=win, setup_s=setup_s)
    names = [m for m in bench["per_layer" if o.trace else "end_to_end"]
             if o.workload in m.get("workloads", [o.workload])]
    metrics = {}
    for m in names:
        v = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if win.trace is not None:
        ctx.notes.append(f"trace: profiler start {win.trace_start_s:.2f} s, "
                         f"traced {win.trace.window_s:.2f} s")
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": cell["chips"], "memory_peak_bytes": int(mem_peak)}
    result = {"correct": passes(checks), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if o.trace and win.trace is not None:
        device["busy_s"] = win.trace.busy_s
        device["window_s"] = win.trace.window_s
        result["breakdown"] = win.trace.breakdown(rec)
    if o.control:
        # the control's numbers, held to the same limits by the same rule
        result["control"] = {"correct": passes(ctrl), "checks": ctrl}
    result["checks"] = checks
    t = o.t_start
    split = []
    for name, t1 in phases:
        split.append(f"{name} {t1 - t:.2f}")
        t = t1
    return result, ["setup_s: " + ", ".join(split)] + ctx.notes + notes


def _warm_up(si, engine, BatchScheduler, streams, mix, dev):
    """Every shape the cell's traffic uses, once: the encoder and the
    search at each power-of-two microbatch up to 32, a prefill at each
    prompt length the streams hold, a decode chunk at the cell's slots."""
    texts = [r.text for s in streams for r in s[:4]]
    b = 1
    while b <= min(32, len(texts)):
        si._batched._search_batch(texts[:b])
        b *= 2
    by_len = {}
    for s in streams:
        for r in s:
            if r.row is None:
                n = len(engine.tok.encode(r.text, bos=True)
                        [: engine.max_len - r.max_new - 1])
                by_len.setdefault(n, r)
    from repro_torch.serving.engine import Request
    sched = BatchScheduler(engine, batch_size=mix["decode_slots"])
    for i, r in enumerate(by_len.values()):
        sched.submit(Request(rid=i, prompt=r.text, max_new=2))
    sched.run_to_completion()
    del sched
    _sync(dev)


class Window:
    """What the window produced: each answered request with its
    client-side times, the pipeline's counters at the edges, the trace."""

    def __init__(self):
        self.t0 = self.t1 = 0.0
        self.done: List[tuple] = []   # (req, t_submit, t_done, result|exc)
        self.sent = 0
        self.stage0: Dict[str, tuple] = {}
        self.stage1: Dict[str, tuple] = {}
        self.exhausted = 0
        self.trace = None
        self.trace_start_s = 0.0


def _stages(pipe) -> Dict[str, tuple]:
    with pipe.stats._lock:
        return {k: (s.items, s.wait_s) for k, s in pipe.stats.stages.items()}


def _window(si, rec, streams, o: Opts, dev, tracer) -> Window:
    win = Window()
    lock = threading.Lock()
    pos = [0] * len(streams)
    pipe = si._batched.serve()
    stop = threading.Event()

    def send(c):
        if stop.is_set():
            return
        with lock:
            if pos[c] >= len(streams[c]):
                win.exhausted += 1
                return
            req = streams[c][pos[c]]
            pos[c] += 1
            win.sent += 1
        t = time.perf_counter()
        try:
            fut = si.submit(req.text, max_new=req.max_new)
        except RuntimeError:
            if stop.is_set():       # the pipeline stopped under the send
                return
            raise
        fut.add_done_callback(lambda f: done(c, req, t, f))

    def done(c, req, t, f):
        t_done = time.perf_counter()
        try:
            res = f.result()
        except BaseException as e:  # noqa: BLE001 — recorded, not raised
            res = e
        with lock:
            win.done.append((req, t, t_done, res))
        if t_done < win.t1:
            send(c)

    win.stage0 = _stages(pipe)
    rec.tracing = tracer is not None
    win.t0 = time.perf_counter()
    win.t1 = win.t0 + o.seconds
    for c in range(len(streams)):
        send(c)
    time.sleep(max(0.0, win.t1 - time.perf_counter()))
    stop.set()
    win.stage1 = _stages(pipe)
    rec.tracing = False
    si._batched.stop_serving(drain=False)
    _sync(dev)
    if tracer is not None:
        tracer.stop()
        win.trace = tracer.read(rec, win.t0, win.t1)
        win.trace_start_s = tracer.start_s
    return win


def held(values: dict, limits: dict) -> dict:
    """Each number that has a limit, beside it."""
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()
            if k in limits}


def passes(checks: dict) -> bool:
    """Correct: every number compared is there and within its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def _answered(win: Window):
    """Requests answered inside the window, with their outcomes."""
    return [(r, ts, td, res) for r, ts, td, res in win.done
            if td <= win.t1 and not isinstance(res, BaseException)]


def _check(cfg, sysc, win, rec, questions, answers, store_embs, mini_w,
           lm_w, ref_tok, enc, limits, seed, dev, control=False):
    """(checks, failed, attempted, notes, control). ``failed`` counts
    answered requests whose outcome is not their design (hit on its row,
    or a miss) and requests that raised; the checks compare the timed
    path's outputs with the reference. ``control`` holds the bf16
    control's numbers to the same limits (only when ``control`` is
    asked for)."""
    rng = np.random.default_rng([seed, 0xC4EC])
    ans = _answered(win)
    row_of = {q: i for i, q in enumerate(questions)}
    failed = sum(1 for _, _, td, res in win.done
                 if td <= win.t1 and isinstance(res, BaseException)
                 and not _cancelled(res))
    wrong = 0
    for req, _, _, res in ans:
        if req.row is None:
            failed += int(res.hit)
            continue
        if not res.hit or row_of.get(res.matched_query) != req.row:
            failed += 1
        elif res.response != answers[req.row]:
            wrong += 1
    prog, notes, ctrl = {}, [], {}
    if any(r.row is not None for r, *_ in ans):
        prog["wrong_answers"] = wrong
    # the encoder and the search, on a sample of the window's searches
    searched = [(t, e, v, i) for s in rec.searches
                if win.t0 <= s.t1 <= win.t1
                for t, e, v, i in zip(s.texts, s.embs, s.scores, s.rows)]
    pick = rng.choice(len(searched), min(64, len(searched)), replace=False) \
        if searched else []
    sample = [searched[i] for i in pick]
    e_err = s_gap = None
    if sample:
        texts = [t for t, *_ in sample]
        e_port = torch.tensor(np.stack([e for _, e, _, _ in sample]),
                              device=dev)
        e_ref = ref_minilm.encode(mini_w, ref_tok, texts, enc["heads"])
        e_err = float((e_port - e_ref).abs().max())
        s = e_port @ store_embs.float().T
        best = s.max(1).values
        rows = torch.tensor([int(i) for *_, i in sample], device=dev)
        at = s.gather(1, rows[:, None])[:, 0]
        vals = torch.tensor([float(v) for *_, v, _ in sample], device=dev)
        s_gap = float(torch.maximum(best - at, (vals - at).abs()).max())
        if control:
            bf = torch.bfloat16
            e16 = ref_minilm.encode(W.cast(mini_w, bf), ref_tok, texts,
                                    enc["heads"])
            ctrl["embed_err"] = float((e16 - e_ref).abs().max())
            s16 = (e_port.to(bf) @ store_embs.to(bf).T).float()
            v16, r16 = s16.max(1)
            at16 = s.gather(1, r16[:, None])[:, 0]
            ctrl["search_gap"] = float(torch.maximum(
                best - at16, (v16 - at16).abs()).max())
    prog.update(embed_err=e_err, search_gap=s_gap, logit_gap=None,
                logit_gap_mean=None, off_top_share=None)
    # the misses: prefill-then-decode tokens against a full forward pass
    served = [(req, rec.finished[req.text]) for req, _, _, res in ans
              if req.row is None and req.text in rec.finished]
    if served:
        ref = reference(cfg)
        served.sort(key=lambda x: -len(x[1]))
        chosen = [served[0]]
        rest = served[1:]
        budget = limits["checked_tokens"] - len(served[0][1])
        for i in rng.permutation(len(rest)):
            if budget <= 0:
                break
            chosen.append(rest[i])
            budget -= len(rest[i][1])
        drops, gaps, cgaps, near = [], [], [], 0
        for req, out in chosen:
            ids = ref_tok.encode(req.text, bos=True)[
                : sysc["max_len"] - req.max_new - 1]
            margins = []
            lg = ref.served_logits(
                cfg, lm_w, ids, out,
                cache_dtype=getattr(torch, cfg["kv_cache_dtype"]),
                drops=drops, margins=margins)
            best = lg.max(1).values
            ids_out = torch.tensor(out, device=dev)[:, None]
            g = best - lg.gather(1, ids_out)[:, 0]
            gaps.append(g)
            if margins:
                near += int((torch.stack(margins).min(0).values[len(ids) - 1:]
                             < 1e-6).sum())
            if control:
                top = ref.served_logits(
                    cfg, lm_w, ids, out,
                    cache_dtype=getattr(torch, cfg["kv_cache_dtype"]),
                    dtype=torch.bfloat16).argmax(1)
                cgaps.append(best - lg.gather(1, top[:, None])[:, 0])
        g = torch.cat(gaps)
        checks_extra = {"logit_gap": float(g.max()),
                        "logit_gap_mean": float(g.mean()),
                        "off_top_share": float((g > 0).float().mean())}
        prog.update(checks_extra)
        notes.append(f"logit_gap over {len(chosen)} misses, "
                     f"{sum(len(o) for _, o in chosen)} served tokens"
                     + (f", {sum(drops)} expert assignments over capacity "
                        f"in their prompts, {near} served positions with a "
                        f"top-k routing margin under 1e-6" if drops else "")
                     + " " + json.dumps(checks_extra))
        if control:
            cg = torch.cat(cgaps)
            ctrl.update(logit_gap=float(cg.max()),
                        logit_gap_mean=float(cg.mean()),
                        off_top_share=float((cg > 0).float().mean()))
    if sample:
        notes.append(f"embed_err and search_gap over {len(sample)} queries")
    if control:
        notes.append("control " + json.dumps(ctrl))
    return (held(prog, limits), failed, win.sent, notes,
            held(ctrl, limits) if control else None)


def _cancelled(e) -> bool:
    from concurrent.futures import CancelledError
    return isinstance(e, CancelledError)
