"""Native (C++) host components of the port, bound through ctypes.

``sdpa_native`` is the SDPA tokenizer that ``io.sdpa.read_sdpa`` uses for
every path.  It is compiled with g++ the first time it is needed, into
``build/hdsdp_tpu_torch/`` at the repository root; a missing compiler, a
failed build or a malformed file raises.  Nothing is built at import.
"""
