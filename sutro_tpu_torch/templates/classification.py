"""Classification template.

The port of ``sutro_tpu/templates/classification.py``: builds an
expert-classifier system prompt from a class list/dict, constrains
output to a fixed ``{scratchpad, classification}`` schema, runs a
detached job, awaits completion, and strips the scratchpad unless
requested. The schema is written as a plain dict, equal to what
pydantic's ``create_model(...).model_json_schema()`` gives for the JAX
package's model, so no pydantic is needed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

from ..interfaces import BaseSutroClient


def _prompt_and_schema(
    classes: Union[List[str], Dict[str, str]], context: Optional[str] = None
) -> Tuple[str, Dict[str, Any]]:
    """The classify job's system prompt and output schema."""
    if isinstance(classes, dict):
        class_lines = "\n".join(
            f"- {label}: {desc}" for label, desc in classes.items()
        )
    else:
        class_lines = "\n".join(f"- {label}" for label in classes)
    labels = list(classes)
    if not labels:
        raise ValueError("classes must be non-empty")

    system_prompt = (
        "You are an expert classifier. Classify the user's input into "
        "exactly one of the following classes:\n"
        f"{class_lines}\n\n"
        "First think briefly in the scratchpad, then answer with the "
        "chosen class label, exactly as written above."
    )
    if context:
        system_prompt += f"\n\nAdditional context:\n{context}"
    # the label enum lists every label as given (pydantic's schema of
    # the JAX template's Enum does); maxLength bounds the scratchpad in the constrained-decoding FSM
    # itself, so a runaway chain of thought can't eat the token budget
    schema = {
        "$defs": {
            "ClassLabel": {
                "enum": labels,
                "title": "ClassLabel",
                "type": "string",
            }
        },
        "properties": {
            "scratchpad": {"maxLength": 400, "title": "Scratchpad", "type": "string"},
            "classification": {"$ref": "#/$defs/ClassLabel"},
        },
        "required": ["scratchpad", "classification"],
        "title": "ClassificationOutput",
        "type": "object",
    }
    return system_prompt, schema


class ClassificationTemplates(BaseSutroClient):
    def classify(
        self,
        data: Any,
        classes: Union[List[str], Dict[str, str]],
        column: Optional[Union[str, List[Any]]] = None,
        model: str = "qwen-3-4b",
        context: Optional[str] = None,
        keep_scratchpad: bool = False,
        job_priority: int = 0,
        name: Optional[str] = None,
        description: Optional[str] = None,
        **kwargs: Any,
    ) -> Any:
        """Classify rows into one of ``classes``.

        ``classes`` may be a list of labels or a dict label->description.
        Returns a DataFrame with a ``classification`` column (plus
        ``scratchpad`` when ``keep_scratchpad=True``)."""
        system_prompt, output_schema = _prompt_and_schema(classes, context)
        # greedy by default: classification wants reproducible labels
        sampling = {"temperature": 0.0}
        sampling.update(kwargs.pop("sampling_params", None) or {})
        job_id = self.infer(
            data,
            model=model,
            column=column,
            output_schema=output_schema,
            system_prompt=system_prompt,
            job_priority=job_priority,
            name=name,
            description=description,
            stay_attached=False,
            sampling_params=sampling,
            **kwargs,
        )
        if job_id is None:
            return None
        results = self.await_job_completion(job_id, unpack_json=True)
        if results is None:
            return None
        if not keep_scratchpad and "scratchpad" in getattr(
            results, "columns", []
        ):
            results = results.drop(columns=["scratchpad"])
        return results
