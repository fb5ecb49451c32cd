"""End-to-end training on the PyTorch port (the counterpart of
``examples/train_small.py``; CUDA unless ``--device cpu``): train a small
LM on the KB corpus with the full substrate — AdamW with an f32 master,
grad accumulation, async checkpointing, restart, and (optional) int8
gradient compression.

  PYTHONPATH=src python examples/train_small_torch.py --steps 200
  PYTHONPATH=src python examples/train_small_torch.py --steps 200 --resume
  PYTHONPATH=src python examples/train_small_torch.py --arch mamba2-130m \
      --full

The default config is a ~20M-param llama-style model; ``--full`` uses the
real 130M mamba2 (the "~100M model" spec point). Checkpoints go to
``--ckpt`` (by default ``repro_torch_train_ckpt`` in the temp directory).
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.kb import build_kb  # noqa: E402
from repro_torch.core.tokenizer import Tokenizer  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training import checkpoint as CK  # noqa: E402
from repro_torch.training import compression as GC  # noqa: E402
from repro_torch.training import data as D  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train as T  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="use the FULL assigned config (mamba2-130m fits)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression w/ error feedback")
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    kb = build_kb("squad", n_docs=60)
    texts = [d.text() for d in kb.docs]
    tok = Tokenizer.from_texts(texts, max_vocab=4096)

    base = get_config(args.arch)
    cfg = base if args.full else dataclasses.replace(
        reduced(base), d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
        n_layers=8)
    cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size)
    print(f"arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M "
          f"steps={args.steps}")

    run = M.RunCfg(attn_impl="naive", remat=False, scan_layers=True)
    ocfg = O.AdamWCfg(lr=1e-3, warmup_steps=20, total_steps=args.steps)

    compress = None
    if args.compress:
        def compress(grads, opt_state):
            dq, err = GC.compress_grads(grads, opt_state["grad_err"])
            return dq, dict(opt_state, grad_err=err)

    step_fn = T.make_train_step(cfg, run, ocfg, accum=args.accum,
                                compress=compress)
    data = D.TextFileData(texts, tok, args.batch, args.seq)
    ck = CK.Checkpointer(args.ckpt)

    start = 0
    if args.resume and ck.latest_step() is not None:
        state, meta = ck.restore(device=dev)
        params, opt = state["params"], state["opt"]
        opt["step"] = opt["step"].cpu()
        if args.compress and "grad_err" not in opt:
            opt["grad_err"] = GC.init_error_state(params)
        start = meta["step"]
        print(f"resumed from step {start}")
    else:
        params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                              dtype=torch.float32, device=dev)
        opt = O.init(params)
        if args.compress:
            opt["grad_err"] = GC.init_error_state(params)

    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        b = {k: torch.from_numpy(v).long().to(dev)
             for k, v in data.batch(i).items()}
        params, opt, m = step_fn(params, opt, b)
        losses.append(float(m["loss"]))
        if (i + 1) % 20 == 0 or i == start:
            print(f"step {i + 1:4d} loss={losses[-1]:.4f} "
                  f"lr={float(m['lr']):.2e} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"({(time.time() - t0) / (i - start + 1):.2f}s/step)")
        if (i + 1) % args.ckpt_every == 0:
            ck.save(i + 1, {"params": params, "opt": opt})
    ck.save(args.steps, {"params": params, "opt": opt}, blocking=True)
    print(f"done; checkpoints in {args.ckpt}")
    return {"start": start, "losses": losses}


if __name__ == "__main__":
    main()
