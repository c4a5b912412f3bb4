from apex_tpu_torch.transformer.functional.fused_rope import (
    fused_apply_rotary_pos_emb_cached,
)
from apex_tpu_torch.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax,
    ScaledUpperTriangMaskedSoftmax,
    ScaledMaskedSoftmax,
    ScaledSoftmax,
    GenericScaledMaskedSoftmax,
)

__all__ = [
    "FusedScaleMaskSoftmax",
    "ScaledUpperTriangMaskedSoftmax",
    "ScaledMaskedSoftmax",
    "ScaledSoftmax",
    "GenericScaledMaskedSoftmax",
    "fused_apply_rotary_pos_emb_cached",
]
