"""Device ms a step of the operations launched inside the ViT's attention
half-block spans, `cerebra_torch.vit.attn` and `cerebra_torch.vit.attn.bwd`
(layer `vit_attn`): every block's forward, the student's and the
teacher's, and the student's backward."""


def read(record):
    t = record.get("trace")
    s = t["layer_s"].get("vit_attn", 0.0) if t else 0.0
    return s / t["steps"] * 1e3 if s > 0 else None
