"""Ops of the port: plain PyTorch attention (``attention``) and the
hand-written paged-decode kernel with its wrapper (``paged_attention``)."""
