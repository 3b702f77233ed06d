"""Local dataset store.

The port of ``sutro_tpu/engine/datasets.py``: ``dataset-<id>``
directories of parquet/csv/txt files under ``$SUTRO_HOME/datasets``,
with the operations the SDK exposes: create, upload, list datasets
(with schema), list files, download, and the rows a job reads.

No pandas: CSV files are read by ``common.read_csv_file`` (the cells as
the JAX package's ``pd.read_csv`` gives them), ``.txt`` by lines, and
parquet through pyarrow, imported where a parquet file is read (an
``ImportError`` naming it where it is missing).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import shutil
import threading
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from ..common import prepare_input_data, read_csv_file
from ..validation import config_dir

logger = logging.getLogger(__name__)


def _root() -> Path:
    d = config_dir() / "datasets"
    d.mkdir(parents=True, exist_ok=True)
    return d


class DatasetStore:
    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root else _root()
        # serializes .meta.json read-modify-writes
        self._lock = threading.Lock()

    @staticmethod
    def _write_meta(d: Path, meta: Dict[str, Any]) -> None:
        """Atomic replace so concurrent readers never see torn JSON.
        Runs under the store lock from ``_touch_meta``: the tiny local
        meta write IS that lock's critical section (serialized RMW)."""
        tmp = d / ".meta.json.tmp"
        # graftlint: disable=lock-blocking-call
        tmp.write_text(json.dumps(meta, indent=2))
        os.replace(tmp, d / ".meta.json")  # graftlint: disable=lock-blocking-call

    def _touch_meta(self, d: Path) -> None:
        with self._lock:
            meta = json.loads((d / ".meta.json").read_text())
            meta["updated_at"] = datetime.datetime.now(
                datetime.timezone.utc
            ).isoformat()
            self._write_meta(d, meta)

    def _dir(self, dataset_id: str) -> Path:
        if not dataset_id.startswith("dataset-"):
            raise ValueError(f"Invalid dataset id: {dataset_id!r}")
        d = self.root / dataset_id
        if not d.exists():
            raise FileNotFoundError(f"Unknown dataset: {dataset_id}")
        return d

    def create(self) -> str:
        dataset_id = f"dataset-{uuid.uuid4().hex[:12]}"
        d = self.root / dataset_id
        d.mkdir(parents=True)
        meta = {
            "dataset_id": dataset_id,
            "datetime_added": datetime.datetime.now(
                datetime.timezone.utc
            ).isoformat(),
            "updated_at": None,
        }
        with self._lock:
            self._write_meta(d, meta)
        return dataset_id

    def upload(
        self, dataset_id: str, paths: List[Union[str, Path]]
    ) -> List[str]:
        d = self._dir(dataset_id)
        names = []
        for p in paths:
            p = Path(p)
            if p.is_dir():
                for f in sorted(p.iterdir()):
                    if f.is_file():
                        shutil.copy2(f, d / f.name)
                        names.append(f.name)
            else:
                shutil.copy2(p, d / p.name)
                names.append(p.name)
        self._touch_meta(d)
        return names

    def upload_bytes(
        self, dataset_id: str, file_name: str, data: bytes
    ) -> str:
        """Write one uploaded file body."""
        d = self._dir(dataset_id)
        name = Path(file_name).name  # strip any client-supplied directories
        if not name or name == ".meta.json":
            raise ValueError(f"Invalid upload file name: {file_name!r}")
        (d / name).write_bytes(data)
        self._touch_meta(d)
        return name

    def list_datasets(self) -> List[Dict[str, Any]]:
        out = []
        for d in sorted(self.root.iterdir()):
            if not d.is_dir() or not d.name.startswith("dataset-"):
                continue
            try:
                meta = json.loads((d / ".meta.json").read_text())
            except (OSError, ValueError) as e:
                # missing/torn meta must not hide the dataset's files —
                # serve id-only metadata, but say why
                logger.warning(
                    "dataset %s: unreadable .meta.json (%s); listing "
                    "with id-only metadata",
                    d.name,
                    e,
                )
                meta = {"dataset_id": d.name}
            meta["schema"] = self._schema(d)
            meta["num_files"] = len(self.list_files(d.name))
            out.append(meta)
        return out

    def _schema(self, d: Path) -> Dict[str, str]:
        """Column name -> dtype name of the first parquet or CSV file
        (a CSV's from its first 10 rows, as pandas infers them)."""
        for f in sorted(d.iterdir()):
            if f.suffix == ".parquet":
                try:
                    import pyarrow.parquet as pq

                    sch = pq.read_schema(f)
                    return {n: str(t) for n, t in zip(sch.names, sch.types)}
                except (ImportError, OSError, ValueError) as e:
                    # ArrowInvalid/ArrowIOError subclass ValueError/OSError
                    logger.warning(
                        "dataset file %s: cannot read parquet schema "
                        "(%s); reporting none",
                        f,
                        e,
                    )
                    return {}
            if f.suffix == ".csv":
                try:
                    return read_csv_file(f, nrows=10)[1]
                except (OSError, ValueError) as e:
                    logger.warning(
                        "dataset file %s: cannot infer csv schema "
                        "(%s); reporting none",
                        f,
                        e,
                    )
                    return {}
        return {}

    def list_files(self, dataset_id: str) -> List[str]:
        d = self._dir(dataset_id)
        return sorted(
            f.name
            for f in d.iterdir()
            # dotfiles excluded: .meta.json and its atomic-replace temp
            if f.is_file() and not f.name.startswith(".")
        )

    def file_path(self, dataset_id: str, file_name: str) -> Path:
        d = self._dir(dataset_id)
        p = (d / file_name).resolve()
        # reject traversal: the resolved path must stay inside the
        # dataset dir (file_name may come from a client)
        if p.parent != d.resolve() or p.name == ".meta.json":
            raise FileNotFoundError(
                f"{dataset_id} has no file {file_name!r}"
            )
        if not p.exists():
            raise FileNotFoundError(f"{dataset_id} has no file {file_name!r}")
        return p

    def download(
        self, dataset_id: str, file_name: str, output_path: Union[str, Path]
    ) -> Path:
        src = self.file_path(dataset_id, file_name)
        out_dir = Path(output_path)
        out_dir.mkdir(parents=True, exist_ok=True)
        dst = out_dir / file_name
        shutil.copy2(src, dst)
        return dst

    def read_rows(
        self, dataset_id: str, column: Optional[Union[str, List[Any]]] = None
    ) -> List[str]:
        """A dataset's rows as a job's inputs: each parquet, CSV and
        ``.txt`` file's rows in file-name order (``common.
        prepare_input_data``)."""
        rows: List[str] = []
        for name in self.list_files(dataset_id):
            p = self.file_path(dataset_id, name)
            if p.suffix in (".parquet", ".csv", ".txt"):
                got = prepare_input_data(str(p), column=column)
                if not isinstance(got, list):
                    raise TypeError(f"{p}: not a list of rows")
                rows.extend(got)
        return rows
