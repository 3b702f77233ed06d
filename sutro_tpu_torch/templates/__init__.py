"""Task templates mixed into ``Sutro`` via MRO."""

from .classification import ClassificationTemplates  # noqa: F401
from .embed import EmbeddingTemplates  # noqa: F401
from .evals import EvalTemplates, Rank, Score  # noqa: F401
