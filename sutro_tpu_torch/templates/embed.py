"""Embeddings template (a copy of ``sutro_tpu/templates/embed.py``): a
thin infer + await wrapper defaulting to ``qwen-3-embedding-0.6b``. The
engine runs the pooled embedding head (models with
``head='embedding'``) through ``ModelRunner.embed_batch``."""

from __future__ import annotations

from typing import Any, List, Optional, Union

from ..interfaces import BaseSutroClient


class EmbeddingTemplates(BaseSutroClient):
    def embed(
        self,
        data: Any,
        column: Optional[Union[str, List[Any]]] = None,
        model: str = "qwen-3-embedding-0.6b",
        output_column: str = "embedding",
        job_priority: int = 0,
        name: Optional[str] = None,
        description: Optional[str] = None,
        **kwargs: Any,
    ) -> Any:
        job_id = self.infer(
            data,
            model=model,
            column=column,
            output_column=output_column,
            job_priority=job_priority,
            name=name,
            description=description,
            stay_attached=False,
            **kwargs,
        )
        if job_id is None:
            return None
        return self.await_job_completion(
            job_id, output_column=output_column, unpack_json=False
        )
