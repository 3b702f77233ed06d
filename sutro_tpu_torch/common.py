"""Data preparation, model registry, and terminal UX helpers.

The part of ``sutro_tpu/common.py`` that the port's client and engine
use, with no third-party import at module level: pandas and polars are
reached only when a DataFrame or a Series is passed (a caller holding
a DataFrame has already imported its package, so the type test reads
``sys.modules``), CSV files are read by this module's own reader (the
cells the JAX package's ``pd.read_csv`` gives), parquet files through
pyarrow where it is installed, pydantic only when a ``BaseModel``
class is passed, tqdm only when a progress bar is drawn, and the
terminal colours are the ANSI escape codes themselves (the codes the
JAX package's colorama constants stand for).
"""

from __future__ import annotations

import math
import sys
from typing import Any, Dict, List, Literal, Optional, Tuple, Union

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


# ---------------------------------------------------------------------------
# CSV without pandas
# ---------------------------------------------------------------------------

# pandas' default NA strings (``read_csv``'s ``na_values``)
CSV_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_CSV_TRUE, _CSV_FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")
_ASCII_SPACE = " \t\n\r\v\f"
_DIGITS = "0123456789"
# the powers of ten the C parser multiplies and divides by, each the
# correctly rounded double of its literal
_POW10 = [float(f"1e{i}") for i in range(309)]
_INT64 = (-(1 << 63), (1 << 63) - 1)
_UINT64_MAX = (1 << 64) - 1


def _csv_records(text: str) -> List[List[str]]:
    """The records of a CSV text, split as pandas' C tokenizer splits
    them (``,`` delimiter, ``"`` quotes with doubled quotes inside,
    ``\\n``, ``\\r\\n`` and ``\\r`` line ends): lines that are empty or
    hold only spaces and tabs outside quotes are skipped, and a quote
    starts a quoted field only at the field's start."""
    records: List[List[str]] = []
    row: List[str] = []
    field: List[str] = []
    i, n = 0, len(text)
    state = "record"
    while i < n:
        c = text[i]
        if state == "record":
            if c in "\r\n":   # a blank line
                i += 2 if text.startswith("\r\n", i) else 1
                continue
            if c in " \t":     # blank unless something else follows on the line
                j = i
                while j < n and text[j] in " \t":
                    j += 1
                if j == n or text[j] in "\r\n":
                    i = j
                    continue
            state = "field"
        if state == "field":
            if c == '"':
                state = "quoted"
            elif c == ",":
                row.append("")
            elif c in "\r\n":
                row.append("")
                records.append(row)
                row, state = [], "record"
                i += 2 if text.startswith("\r\n", i) else 1
                continue
            else:
                field.append(c)
                state = "unquoted"
        elif state == "unquoted":
            if c == ",":
                row.append("".join(field))
                field, state = [], "field"
            elif c in "\r\n":
                row.append("".join(field))
                records.append(row)
                field, row, state = [], [], "record"
                i += 2 if text.startswith("\r\n", i) else 1
                continue
            else:
                field.append(c)
        elif state == "quoted":
            if c == '"':
                state = "quote_in_quoted"
            else:
                field.append(c)
        else:  # a quote inside a quoted field: doubled, or the field's end
            if c == '"':
                field.append(c)
                state = "quoted"
            elif c == ",":
                row.append("".join(field))
                field, state = [], "field"
            elif c in "\r\n":
                row.append("".join(field))
                records.append(row)
                field, row, state = [], [], "record"
                i += 2 if text.startswith("\r\n", i) else 1
                continue
            else:
                field.append(c)
                state = "unquoted"
        i += 1
    if state == "quoted":
        raise ValueError("CSV: end of file inside a quoted field")
    if state != "record":
        row.append("".join(field))
        records.append(row)
    return records


def _csv_int(cell: str) -> Optional[int]:
    """pandas' C integer parse: optional ASCII spaces around an optional
    sign and ASCII digits; None when the cell is not an integer."""
    t = cell.strip(_ASCII_SPACE)
    body = t[1:] if t[:1] in ("+", "-") else t
    if not body or any(ch not in _DIGITS for ch in body):
        return None
    return int(t)


def _csv_float(cell: str) -> Optional[float]:
    """pandas' C float parse (its ``precise_xstrtod``, the default
    ``float_precision``): at most 17 significant digits accumulated in
    a double, then one scaling by a power of ten, so the result can
    differ from the correctly rounded ``float(cell)`` in its last bits;
    ``inf``/``infinity`` names as the parser takes them. None when the
    cell is not a float."""
    low = cell.lower()
    if low in ("inf", "+inf", "infinity", "+infinity"):
        return math.inf
    if low in ("-inf", "-infinity"):
        return -math.inf
    n, p = len(cell), 0
    while p < n and cell[p] in _ASCII_SPACE:
        p += 1
    neg = p < n and cell[p] == "-"
    if p < n and cell[p] in "+-":
        p += 1
    number, exponent, digits = 0.0, 0, 0
    while p < n and cell[p] in _DIGITS:
        if digits < 17:
            number = number * 10.0 + (ord(cell[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and cell[p] == ".":
        p += 1
        decimals = 0
        while digits < 17 and p < n and cell[p] in _DIGITS:
            number = number * 10.0 + (ord(cell[p]) - 48)
            digits += 1
            decimals += 1
            p += 1
        while p < n and cell[p] in _DIGITS:
            p += 1
        exponent -= decimals
    if digits == 0:
        return None
    if neg:
        number = -number
    if p < n and cell[p] in "eE":
        q = p + 1
        eneg = q < n and cell[q] == "-"
        if q < n and cell[q] in "+-":
            q += 1
        e, e_digits = 0, 0
        while e_digits < 17 and q < n and cell[q] in _DIGITS:
            e = e * 10 + (ord(cell[q]) - 48)
            e_digits += 1
            q += 1
        if e_digits:
            exponent += -e if eneg else e
            p = q
    while p < n and cell[p] in _ASCII_SPACE:
        p += 1
    if p != n:
        return None
    if exponent > 308:
        return number * math.inf if number else number
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _csv_column(cells: List[Optional[str]]) -> Tuple[str, List[str]]:
    """One column's cells (None where a row was short) -> (the dtype
    pandas infers, each cell as ``str`` of its parsed value): int64 or
    uint64 when every cell is an integer in range, float64 when every
    non-NA cell is a number (NA -> ``"nan"``; integers with NA convert
    exactly rounded, other numbers as :func:`_csv_float` parses them), bool when every cell is
    a boolean word (``object`` with NA), else the text itself. An
    integer out of both ranges before any non-integer cell keeps the
    column's text (``object``), as pandas does."""
    na = [c is None or c in CSV_NA_VALUES for c in cells]
    vals = [c for c, m in zip(cells, na) if not m]
    if vals:
        ints: List[int] = []
        for c in vals:
            v = _csv_int(c)
            if v is None:
                break
            ints.append(v)
        if len(ints) < len(vals) and ints and not (_INT64[0] <= ints[-1] <= _INT64[1]):
            # the first out-of-int64 cell came before the first non-integer
            return "object", ["nan" if m else c for c, m in zip(cells, na)]
        if len(ints) == len(vals):
            lo, hi = min(ints), max(ints)
            if not any(na) and _INT64[0] <= lo and hi <= _INT64[1]:
                return "int64", [str(v) for v in ints]
            if not any(na) and lo >= 0 and hi <= _UINT64_MAX:
                return "uint64", [str(v) for v in ints]
            if not (_INT64[0] <= lo and hi <= _UINT64_MAX) or (lo < 0 and hi > _INT64[1]):
                return "object", ["nan" if m else c for c, m in zip(cells, na)]
            # integers with NA: parsed as integers, then cast to float64;
            # the parser's NA marker is INT64_MIN, so that value reads NaN
            it = iter(ints)
            return "float64", [
                "nan" if m or v == _INT64[0] else str(float(v))
                for m, v in ((m, None if m else next(it)) for m in na)
            ]
        floats = [_csv_float(c) for c in vals]
        if all(f is not None for f in floats):
            it = iter(floats)
            return "float64", ["nan" if m else str(next(it)) for m in na]
        if all(c in _CSV_TRUE or c in _CSV_FALSE for c in vals):
            return ("object" if any(na) else "bool"), [
                "nan" if m else str(c in _CSV_TRUE) for c, m in zip(cells, na)
            ]
        return "str", ["nan" if m else c for c, m in zip(cells, na)]
    return "float64", ["nan"] * len(cells)


def read_csv_text(
    text: str, nrows: Optional[int] = None
) -> Tuple[Dict[str, List[str]], Dict[str, str]]:
    """A CSV text -> (column name -> cells as strings, column name ->
    dtype name), the strings ``[str(x) for x in
    pd.read_csv(...)[name].tolist()]`` gives: the JAX package reads CSV
    with pandas, and the card's machine has no pandas, so the port reads
    it with this one reader everywhere. The header is the first record
    (an empty name becomes ``Unnamed: <i>``, a repeated one ``<name>.<k>``);
    short rows are NA-filled; a row longer than the header raises.
    ``nrows`` reads (and infers the dtypes from) the first rows only."""
    records = _csv_records(text[1:] if text.startswith("\ufeff") else text)
    if not records:
        raise ValueError("No columns to parse from file")
    names: List[str] = []
    seen: Dict[str, int] = {}
    for i, h in enumerate(records[0]):
        name = h or f"Unnamed: {i}"
        if name in seen:
            seen[name] += 1
            name = f"{name}.{seen[name]}"
        else:
            seen[name] = 0
        names.append(name)
    rows = records[1:] if nrows is None else records[1 : 1 + nrows]
    for k, r in enumerate(rows):
        if len(r) > len(names):
            raise ValueError(
                f"Error tokenizing data: expected {len(names)} fields in "
                f"line {k + 2}, saw {len(r)}"
            )
    columns: Dict[str, List[str]] = {}
    dtypes: Dict[str, str] = {}
    for j, name in enumerate(names):
        dtypes[name], columns[name] = _csv_column(
            [r[j] if j < len(r) else None for r in rows]
        )
    return columns, dtypes


def read_csv_file(
    path: Any, nrows: Optional[int] = None
) -> Tuple[Dict[str, List[str]], Dict[str, str]]:
    """:func:`read_csv_text` of a file (``.gz`` decompressed)."""
    if str(path).endswith(".gz"):
        import gzip

        with gzip.open(path, "rb") as f:
            return read_csv_text(f.read().decode("utf-8"), nrows)
    with open(path, encoding="utf-8", newline="") as f:
        return read_csv_text(f.read(), nrows)


def read_parquet_columns(source: Any) -> Dict[str, List[Any]]:
    """A parquet file (path or file object) -> column name -> values as
    ``pd.read_parquet(...)[name].tolist()`` gives them: an integer
    column with nulls as floats with NaN, a null number or string as
    NaN, a null boolean as None. Needs pyarrow."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(
            "reading a parquet file needs the pyarrow package, which is "
            "not installed; pass a CSV or .txt file instead"
        ) from e
    table = pq.read_table(source)
    out: Dict[str, List[Any]] = {}
    for name in table.column_names:
        col = table.column(name)
        vals = col.to_pylist()
        if col.null_count and not str(col.type).startswith("bool"):
            as_float = str(col.type).startswith(("int", "uint"))
            vals = [
                math.nan if v is None else float(v) if as_float else v
                for v in vals
            ]
        out[name] = vals
    return out


def _table_column(columns: Dict[str, List[Any]], column: Union[str, List[Any]]) -> List[str]:
    """A column of a table read by this module as strings, or the
    row-wise concatenation of a list of column names and literal
    strings (a row with an NA cell in a named column is ``"nan"``, as
    pandas' string sum gives NaN there)."""
    if isinstance(column, list):
        n = len(next(iter(columns.values()), []))
        parts = [columns[c] if c in columns else [str(c)] * n for c in column]
        na = lambda x: x is None or x != x or x == "nan"  # noqa: E731
        return [
            "nan" if any(c in columns and na(x) for c, x in zip(column, p))
            else "".join(str(x) for x in p)
            for p in zip(*parts)
        ] if parts else []
    if column not in columns:
        raise KeyError(column)
    return [str(x) for x in columns[column]]


def prepare_input_data(
    data: Any,
    column: Optional[Union[str, List[Any]]] = None,
) -> Union[List[str], str]:
    """Normalize user input into the engine's ``inputs`` payload.

    Accepts a list of strings, a pandas/polars DataFrame (requires
    ``column``) or Series, a path to ``.csv`` (read by
    :func:`read_csv_file`, no pandas), ``.parquet`` (pyarrow) or
    ``.txt``, a ``dataset-<id>`` string or an http(s) URL (both passed
    through for the engine to resolve). Returns a list of row strings,
    or the untouched dataset-id/URL string.
    """
    if isinstance(data, str):
        if data.startswith("dataset-"):
            return data
        if data.startswith("http://") or data.startswith("https://"):
            return data
        lower = data.lower()
        if lower.endswith(".csv"):
            columns, _ = read_csv_file(data)
            if column is None:
                raise ValueError("`column` is required when passing a CSV file")
            return _table_column(columns, column)
        if lower.endswith(".parquet"):
            columns = read_parquet_columns(data)
            if column is None:
                raise ValueError("`column` is required when passing a Parquet file")
            return _table_column(columns, column)
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
