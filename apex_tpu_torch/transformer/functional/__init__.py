from apex_tpu_torch.transformer.functional.fused_rope import (
    fused_apply_rotary_pos_emb_cached,
)

__all__ = ["fused_apply_rotary_pos_emb_cached"]
