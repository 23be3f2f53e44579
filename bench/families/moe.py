"""Family ``moe`` (``olmoe-1b-7b``): every layer full causal attention
with split-half RoPE and the dropless top-k SwiGLU expert layer.  Its
functions are ``bench/decoder.py``'s, shared with ``dense``."""

from bench.decoder import (attention_launches, attention_work,  # noqa: F401
                           forward_logits, model_flops, program_config,
                           spec, weights)
