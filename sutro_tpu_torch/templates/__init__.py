"""Task templates mixed into ``Sutro`` via MRO."""

from .classification import ClassificationTemplates  # noqa: F401
