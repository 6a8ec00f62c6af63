#!/usr/bin/env python3
"""The ``prot_t5`` branch of ``scripts/torch_import_jax_model.py`` at
ProtT5-XL width, on the CPU.

    python scripts/torch_import_check_xl.py [--blocks 2] [--out DIR]

Builds a JAX ``deepblast-train`` directory whose ``lm_type="prot_t5"``
encoder has ProtT5-XL's width (d_model 1,024, d_ff 16,384, 32 heads) and
``--blocks`` of its 24 blocks (the JAX ``T5Config.prot_t5_xl`` patched in
this process), seeded weights saved by the JAX ``Checkpointer``; converts
it with the script; and prints one JSON line: the ``"t5"`` block written,
the LM's parameters, the seconds to save and to convert, whether the
port's ``align`` equals the JAX ``load_model``'s on 3 protein pairs, the
largest relative difference of ``score_pairs``, the size of ``model.pt``
and the peak resident memory.  The full encoder (``--blocks 24``, 1.2 B
parameters) needs ~30 GiB of host memory.
"""

import argparse
import json
import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PAIRS = [("HECDRKTCDESFSTKGNLRVHKLGH", "LKCSGCGKNFKSQYAYKRHEQTH"),
         ("YRCHKVCPYTFVGKSDLDLHQFITAH", "HECDDCSKQFSRNNHLAKHLRAH"),
         ("YACSGGCGQNFRTMSEFNEHMIRLVH", "LICPKHTRDCGKVFKRNSSLRVHEH")]


def main(argv=None):
    parser = argparse.ArgumentParser("torch_import_check_xl")
    parser.add_argument("--blocks", type=int, default=2)
    parser.add_argument("--out", default=None,
                        help="working directory (default: a temporary one)")
    args = parser.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from deepblast_torch.data.state_utils import pad_sequences
    from deepblast_torch.train.checkpoint import load_model
    from deepblast_tpu.models import lm as jlm
    from deepblast_tpu.train import checkpoint as jck
    from deepblast_tpu.train import trainer as jtrainer
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_import_jax_model as imp

    jlm.T5Config.prot_t5_xl = classmethod(lambda cls, **kw: cls(
        vocab_size=128, d_model=1024, d_kv=128, d_ff=16384,
        num_layers=args.blocks, num_heads=32, **kw))
    with tempfile.TemporaryDirectory() as tmp:
        root = args.out or tmp
        jax_dir, out = os.path.join(root, "jax"), os.path.join(root, "port")
        cfg = jtrainer.DeepBLASTConfig(lm_type="prot_t5", embedding_dim=1024,
                                       hidden_dim=64, layers=2, seed=3,
                                       dp_bf16_residuals=False)
        t0 = time.time()
        state = jtrainer.DeepBLAST(cfg).init(jax.random.key(7))
        jck.save_config(cfg, jax_dir)
        jck.Checkpointer(os.path.join(jax_dir, "checkpoints")).save(
            state.replace(step=jnp.asarray(5, jnp.int32)),
            {"validation_loss": 1.0})
        del state
        t1 = time.time()
        imp.import_jax_model(jax_dir, out)
        t2 = time.time()
        jmodel, tmodel = jck.load_model(jax_dir), load_model(out,
                                                              device="cpu")
        same = [tmodel.align(x, y) == jmodel.align(x, y) for x, y in PAIRS]
        tok = tmodel.tokenizer
        xt, xl = pad_sequences([tok(x)[0] for x, _ in PAIRS])
        yt, yl = pad_sequences([tok(y)[0] for _, y in PAIRS])
        batch = dict(x=xt, y=yt, x_len=xl, y_len=yl)
        want = np.asarray(jmodel.score_pairs(
            jmodel.state, {k: jnp.asarray(v) for k, v in batch.items()}))
        got = tmodel.score_pairs(batch).numpy()
        with open(os.path.join(out, "config.json")) as f:
            t5 = json.load(f)["t5"]
        print(json.dumps(dict(
            t5=t5, lm_parameters=sum(p.numel()
                                     for p in tmodel.lm.parameters()),
            save_s=round(t1 - t0, 1), convert_s=round(t2 - t1, 1),
            align_equal=same,
            score_max_rel=float(np.max(np.abs(got - want) / np.abs(want))),
            model_pt_bytes=os.path.getsize(os.path.join(out, "model.pt")),
            peak_rss_gib=round(resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 2**20, 2))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
