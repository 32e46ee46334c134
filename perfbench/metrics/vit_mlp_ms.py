"""Device ms a step of the operations launched inside the ViT's MLP
half-block spans, `cerebra_torch.vit.mlp` and `cerebra_torch.vit.mlp.bwd`
(layer `vit_mlp`): every block's forward, the student's and the
teacher's, and the student's backward."""


def read(record):
    t = record.get("trace")
    s = t["layer_s"].get("vit_mlp", 0.0) if t else 0.0
    return s / t["steps"] * 1e3 if s > 0 else None
