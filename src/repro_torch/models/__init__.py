"""The port's model layer: dense layers, RoPE, grouped-query attention,
attention+MLP blocks and the decoder LM."""
