from .input_spec import InputSpec  # noqa: F401
