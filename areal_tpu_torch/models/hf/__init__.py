"""HF checkpoint conversion for the port (counterpart of
``areal_tpu/models/hf``). Only the families of the ported slice are here:
llama and qwen2."""
