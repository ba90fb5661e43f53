"""Attention, conv-encoder and decode-loop kernels with their plain versions."""
