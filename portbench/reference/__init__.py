"""The plain float32 reference the benchmark holds the program against.

Imports nothing of the program (``repro_torch``) and nothing of JAX.
"""
