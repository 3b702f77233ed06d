"""Schema-constrained decoding: JSON schema -> byte NFA -> token masks.

Port of ``sutro_tpu/engine/constrain/`` (pure Python plus the host C++
mask core ``native/fsm.cpp``; nothing here runs on the card). Public
surface: ``schema_constraint_factory(schema, tokenizer)`` returning a
per-row ``TokenFSM`` factory, which ``GenRequest.constraint`` /
``constraint_factory`` take; the scheduler turns its masks into the
runner's ``allowed`` / ``allowed0`` operands and verifies speculative
tokens against it.
"""

from .fsm import (  # noqa: F401
    ConstraintFactory,
    MaskCache,
    TokenFSM,
    TokenTable,
    schema_constraint_factory,
)
from .schema import compile_schema  # noqa: F401
