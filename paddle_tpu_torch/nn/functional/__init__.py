from .attention import scaled_dot_product_attention  # noqa: F401
