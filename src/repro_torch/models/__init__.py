"""Model zoo of the port: the decoder (dense or MoE) and its Q + LR
layers."""
from repro_torch.models.linear import Ctx, FpLinear, QLinear, linear
from repro_torch.models.transformer import (LM, decode_step, forward,
                                            init_cache, init_lm, lm_loss,
                                            prefill, prefill_chunk,
                                            verify_chunk)

__all__ = ["Ctx", "FpLinear", "QLinear", "linear", "LM", "decode_step",
           "forward", "init_cache", "init_lm", "lm_loss", "prefill",
           "prefill_chunk", "verify_chunk"]
