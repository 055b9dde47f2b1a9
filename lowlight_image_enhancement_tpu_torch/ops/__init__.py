"""Ops of the port: LayerNorm2d and the fused NAFBlock forward (K1/K2)."""
