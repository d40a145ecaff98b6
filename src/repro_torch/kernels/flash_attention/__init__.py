from .ops import flash_attention, flash_attention_lse
from .ref import attention_lse_ref, attention_ref

__all__ = ["attention_lse_ref", "attention_ref", "flash_attention",
           "flash_attention_lse"]
