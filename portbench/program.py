"""The system under test as a configuration file states it: a
``deepblast_torch`` ``DeepBLAST`` with the benchmark's seeded weights.
The harness takes only the program's entry points from here."""

from __future__ import annotations

import torch

from portbench import weights

__all__ = ["deepblast_config", "build"]


def deepblast_config(cfg, mix, seed):
    """The program's ``DeepBLASTConfig`` of configuration ``cfg`` under
    mix ``mix``."""
    from deepblast_torch.train.trainer import DeepBLASTConfig
    h, a, t = cfg["heads"], cfg["alignment"], cfg["training"]
    return DeepBLASTConfig(
        embedding_dim=h["embedding_dim"], hidden_dim=h["hidden_dim"],
        layers=h["layers"], k_size=h["k_size"], dropout=h["dropout"],
        layer_type=h["layer_type"], alignment_mode=a["mode"],
        operator=a["operator"], backend=a["backend"],
        dp_bf16_residuals=a["dp_bf16_residuals"], lm_type="prot_t5",
        batch_size=mix.get("batch_size", 32),
        learning_rate=t["learning_rate"], epochs=1,
        scheduler=t["scheduler"], loss=t["loss"], grad_clip=t["grad_clip"],
        steps_per_dispatch=mix.get("steps_per_dispatch", 1),
        mask_gaps=t["mask_gaps"], seed=int(seed) % 2**31,
        precision=cfg["precision"], max_len=t["max_len"],
        pad_multiple=mix.get("pad_multiple", 16),
        visualization_fraction=0.0)


def build(cfg, mix, seed, device):
    """``(model, p0)``: the program's model on ``device`` holding the
    weights of ``seed``, and a copy of the trained leaves' first values."""
    from deepblast_torch.models.lm import T5Config, T5Encoder
    from deepblast_torch.train.trainer import DeepBLAST
    lm_specs, head_specs = weights.specs(cfg)
    geometry = {k: cfg["lm"][k] for k in (
        "vocab_size", "d_model", "d_kv", "d_ff", "num_layers", "num_heads",
        "relative_attention_num_buckets", "relative_attention_max_distance",
        "layer_norm_epsilon", "feed_forward_proj")}
    lm_w = weights.make(lm_specs, seed, device, "lm")
    lm = T5Encoder(T5Config(**geometry, dtype="float32"), device=device)
    model = DeepBLAST(deepblast_config(cfg, mix, seed), lm=lm,
                      lm_params=lm_w, device=device)
    del lm_w
    model.aligner.load_state_dict(weights.make(head_specs, seed, device,
                                               "heads"))
    p0 = {n: p.detach().clone() for n, p in model.aligner.named_parameters()
          if p.requires_grad}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return model, p0

