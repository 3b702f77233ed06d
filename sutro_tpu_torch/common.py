"""Data preparation, model registry, and terminal UX helpers.

The part of ``sutro_tpu/common.py`` that the port's client and engine
use, with no third-party import at module level: pandas and polars are
reached only when a DataFrame, a Series or a file path is passed (a
caller holding a DataFrame has already imported its package, so the
type test reads ``sys.modules``), pydantic only when a ``BaseModel``
class is passed, tqdm only when a progress bar is drawn, and the
terminal colours are the ANSI escape codes themselves (the codes the
JAX package's colorama constants stand for).
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Literal, Optional, Union

# ---------------------------------------------------------------------------
# Model registry
# ---------------------------------------------------------------------------

# Public model names (autocompletion); `| str` keeps the escape hatch
# used for Functions.
ModelOptions = Union[
    Literal[
        "llama-3.2-3b",
        "llama-3.1-8b",
        "llama-3.3-70b",
        "qwen-3-0.6b",
        "qwen-3-4b",
        "qwen-3-8b",
        "qwen-3-14b",
        "qwen-3-32b",
        "qwen-3-30b-a3b",
        "qwen-3-235b-a22b",
        "qwen-3-4b-thinking",
        "qwen-3-14b-thinking",
        "qwen-3-32b-thinking",
        "qwen-3-235b-a22b-thinking",
        "qwen-3-30b-a3b-thinking",
        "gemma-3-4b-it",
        "gemma-3-12b-it",
        "gemma-3-27b-it",
        "gpt-oss-20b",
        "gpt-oss-120b",
        "qwen-3-embedding-0.6b",
        "qwen-3-embedding-6b",
        "qwen-3-embedding-8b",
    ],
    str,
]


def model_catalog() -> Dict[str, Dict[str, Any]]:
    """Public model name -> engine metadata.

    ``engine_key`` indexes ``models.configs.MODEL_CONFIGS``;
    ``thinking`` toggles reasoning-content output unpacking;
    ``embedding`` selects the pooled-embedding head path.
    """
    cat: Dict[str, Dict[str, Any]] = {}

    def add(name: str, engine_key: str, **kw: Any) -> None:
        cat[name] = {"engine_key": engine_key, "thinking": False, "embedding": False, **kw}

    add("llama-3.2-3b", "llama-3.2-3b")
    add("llama-3.1-8b", "llama-3.1-8b")
    add("llama-3.3-70b", "llama-3.3-70b")
    add("qwen-3-0.6b", "qwen3-0.6b")
    add("qwen-3-4b", "qwen3-4b")
    add("qwen-3-8b", "qwen3-8b")
    add("qwen-3-14b", "qwen3-14b")
    add("qwen-3-32b", "qwen3-32b")
    add("qwen-3-30b-a3b", "qwen3-30b-a3b")
    add("qwen-3-235b-a22b", "qwen3-235b-a22b")
    for base in ["qwen-3-4b", "qwen-3-14b", "qwen-3-32b", "qwen-3-235b-a22b", "qwen-3-30b-a3b"]:
        add(base + "-thinking", cat[base]["engine_key"], thinking=True)
    add("gemma-3-4b-it", "gemma3-4b")
    add("gemma-3-12b-it", "gemma3-12b")
    add("gemma-3-27b-it", "gemma3-27b")
    add("gpt-oss-20b", "gpt-oss-20b")
    add("gpt-oss-120b", "gpt-oss-120b")
    add("qwen-3-embedding-0.6b", "qwen3-emb-0.6b", embedding=True)
    add("qwen-3-embedding-6b", "qwen3-emb-6b", embedding=True)
    add("qwen-3-embedding-8b", "qwen3-emb-8b", embedding=True)
    return cat


MODEL_CATALOG = model_catalog()

# ---------------------------------------------------------------------------
# Terminal UX
# ---------------------------------------------------------------------------

# ANSI SGR codes: colorama's Fore.BLUE/GREEN/RED/MAGENTA and Style.RESET_ALL
_BLUE, _GREEN, _RED, _MAGENTA, _RESET = (
    "\x1b[34m", "\x1b[32m", "\x1b[31m", "\x1b[35m", "\x1b[0m",
)
BASE_OUTPUT_COLOR = _BLUE


def is_jupyter() -> bool:
    """Jupyter/non-tty detection."""
    return not sys.stdout.isatty()


def make_clickable_link(url: str, text: Optional[str] = None) -> str:
    """OSC-8 clickable hyperlink with plain fallback."""
    if is_jupyter():
        return url
    label = text or url
    return f"\033]8;;{url}\033\\{label}\033]8;;\033\\"


def to_colored_text(text: str, state: Optional[str] = None) -> str:
    """Color text by state: success=green, fail=red, callout=magenta,
    default=blue."""
    if state == "success":
        color = _GREEN
    elif state in ("fail", "error"):
        color = _RED
    elif state == "callout":
        color = _MAGENTA
    else:
        color = BASE_OUTPUT_COLOR
    return f"{color}{text}{_RESET}"


def fancy_tqdm(
    total: int,
    desc: str = "Progress",
    color: str = "blue",
    style: int = 1,
    postfix: Optional[str] = None,
):
    """Styled progress bar (tqdm is imported here, not at module level)."""
    from tqdm.auto import tqdm

    if style == 1:
        bar_format = (
            "{desc}: {percentage:3.0f}%|{bar}| {n_fmt}/{total_fmt} "
            "[{elapsed}<{remaining}, {rate_fmt}{postfix}]"
        )
    else:
        bar_format = "{l_bar}{bar}{r_bar}"
    return tqdm(
        total=total,
        desc=desc,
        colour=color,
        bar_format=bar_format,
        postfix=postfix,
        dynamic_ncols=True,
    )


class Spinner:
    """Minimal spinner: a context manager printing ``text`` once on
    entry and a state glyph on exit; exposes ``.text``, ``.ok()``,
    ``.fail()``, ``.stop()``.
    """

    def __init__(self, text: str = "", color: Optional[str] = None):
        self.text = text
        self._done = False

    def __enter__(self) -> "Spinner":
        if self.text:
            print(to_colored_text(self.text), flush=True)
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    def write(self, msg: str) -> None:
        print(msg, flush=True)

    def ok(self, glyph: str = "✔") -> None:
        if not self._done:
            print(to_colored_text(f"{glyph} {self.text}", "success"), flush=True)
            self._done = True

    def fail(self, glyph: str = "✗") -> None:
        if not self._done:
            print(to_colored_text(f"{glyph} {self.text}", "fail"), flush=True)
            self._done = True

    def stop(self) -> None:
        self._done = True


# ---------------------------------------------------------------------------
# Input data preparation
# ---------------------------------------------------------------------------


def _loaded(name: str):
    """The module ``name`` if something already imported it, else None:
    a DataFrame of a package nobody imported cannot exist."""
    return sys.modules.get(name)


def do_dataframe_column_concatenation(df: Any, column: List[Any]) -> List[str]:
    """Concatenate multiple columns (with literal separator strings) into
    one list of row strings. ``column`` is a list whose elements are
    either column names or literal separator strings, e.g.
    ``["title", ": ", "body"]``."""
    pl, pd = _loaded("polars"), _loaded("pandas")
    if pl is not None and isinstance(df, pl.DataFrame):
        names = set(df.columns)
        exprs = [
            pl.col(c).cast(pl.Utf8) if c in names else pl.lit(str(c))
            for c in column
        ]
        return df.select(pl.concat_str(exprs).alias("__concat__"))["__concat__"].to_list()
    if pd is not None and isinstance(df, pd.DataFrame):
        names = set(df.columns)
        out = None
        for c in column:
            part = (
                df[c].astype(str)
                if c in names
                else pd.Series([str(c)] * len(df), index=df.index)
            )
            out = part if out is None else out + part
        return [] if out is None else out.tolist()
    raise ValueError(f"Unsupported dataframe type: {type(df)}")


def _column_to_list(df: Any, column: Union[str, List[Any]]) -> List[str]:
    if isinstance(column, list):
        return do_dataframe_column_concatenation(df, column)
    pl = _loaded("polars")
    if pl is not None and isinstance(df, pl.DataFrame):
        return [str(x) for x in df[column].to_list()]
    return [str(x) for x in df[column].tolist()]


def prepare_input_data(
    data: Any,
    column: Optional[Union[str, List[Any]]] = None,
) -> Union[List[str], str]:
    """Normalize user input into the engine's ``inputs`` payload.

    Accepts a list of strings, a pandas/polars DataFrame (requires
    ``column``) or Series, a path to ``.csv``/``.parquet``/``.txt``, a
    ``dataset-<id>`` string or an http(s) URL (both passed through for
    the engine, which refuses them: datasets and URL inputs are not
    ported). Returns a list of row strings, or the untouched
    dataset-id/URL string.
    """
    if isinstance(data, str):
        if data.startswith("dataset-"):
            return data
        if data.startswith("http://") or data.startswith("https://"):
            return data
        lower = data.lower()
        if lower.endswith(".csv"):
            import pandas as pd

            df = pd.read_csv(data)
            if column is None:
                raise ValueError("`column` is required when passing a CSV file")
            return _column_to_list(df, column)
        if lower.endswith(".parquet"):
            import pandas as pd

            df = pd.read_parquet(data)
            if column is None:
                raise ValueError("`column` is required when passing a Parquet file")
            return _column_to_list(df, column)
        if lower.endswith(".txt"):
            with open(data) as f:
                return [line.rstrip("\n") for line in f if line.strip()]
        raise ValueError(
            f"Unsupported input: {data!r}. Expected a list of strings, a "
            "DataFrame, a .csv/.parquet/.txt path, a dataset-<id>, or a URL."
        )
    if isinstance(data, (list, tuple)):
        return [str(x) for x in data]
    pd, pl = _loaded("pandas"), _loaded("polars")
    if pd is not None and isinstance(data, pd.Series):
        return [str(x) for x in data.tolist()]
    if (pd is not None and isinstance(data, pd.DataFrame)) or (
        pl is not None and isinstance(data, pl.DataFrame)
    ):
        if column is None:
            raise ValueError(
                "`column` must be specified when passing a DataFrame"
            )
        return _column_to_list(data, column)
    if pl is not None and isinstance(data, pl.Series):
        return [str(x) for x in data.to_list()]
    raise ValueError(f"Unsupported input data type: {type(data)}")


def normalize_output_schema(output_schema: Any) -> Optional[Dict[str, Any]]:
    """Pydantic model class or dict -> JSON schema dict."""
    if output_schema is None:
        return None
    if isinstance(output_schema, dict):
        return output_schema
    pydantic = _loaded("pydantic")
    if (
        pydantic is not None
        and isinstance(output_schema, type)
        and issubclass(output_schema, pydantic.BaseModel)
    ):
        return output_schema.model_json_schema()
    raise ValueError(
        "output_schema must be a Pydantic BaseModel subclass or a JSON-schema dict, "
        f"got {type(output_schema)}"
    )


def human_bytes(n: float) -> str:
    for unit in ["B", "KB", "MB", "GB", "TB"]:
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} PB"
