"""Plain PyTorch references of Magpie TTS, its codec and its sampling rule.

They import nothing of the program under test (``magpie_tts_tpu_torch``)
and nothing of JAX; they take only the weights and inputs the benchmark made.
"""
