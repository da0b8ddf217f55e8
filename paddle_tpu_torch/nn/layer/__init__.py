from .loss import CrossEntropyLoss  # noqa: F401
