"""Dense decoder-LM layers and the ``DecoderLM`` module."""
