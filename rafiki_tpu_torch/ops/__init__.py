"""Attention ops: the flash-attention kernels and multi-head attention."""

from rafiki_tpu_torch.ops.attention import mha_reference, multi_head_attention
from rafiki_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

__all__ = ["flash_attention", "flash_attention_bwd_plain",
           "flash_attention_plain", "mha_reference", "multi_head_attention"]
