"""Model zoo of the port: the ten families' decoder (and whisper's
encoder) over the Q + LR layers. JAX's ``init_linear``,
``is_linear_params`` and ``apply_block`` have no counterpart: a layer is
an ``nn.Module`` built by its constructor, ``isinstance(m, QLinear)``
tells a quantized one, and a block runs by its ``forward``."""
from repro_torch.models.linear import (Ctx, FpLinear, QLinear, dequant_weight,
                                       linear)
from repro_torch.models.transformer import (LM, decode_step, forward,
                                            init_cache, init_lm, layer_layout,
                                            lm_loss, prefill, prefill_chunk,
                                            verify_chunk)

__all__ = ["Ctx", "FpLinear", "QLinear", "dequant_weight", "linear", "LM",
           "decode_step", "forward", "init_cache", "init_lm", "layer_layout",
           "lm_loss", "prefill", "prefill_chunk", "verify_chunk"]
