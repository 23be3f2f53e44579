"""Family ``dense`` (``olmo-1b``): every layer full causal attention with
split-half RoPE and a SwiGLU MLP.  Its functions are
``bench/decoder.py``'s, shared with ``moe``."""

from bench.decoder import (attention_launches, attention_work,  # noqa: F401
                           forward_logits, model_flops, program_config,
                           spec, weights)
