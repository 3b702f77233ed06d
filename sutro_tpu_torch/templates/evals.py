"""Eval templates: LLM-judge scoring, ranking, and Elo (a copy of
``sutro_tpu/templates/evals.py``).

- ``Score.score``: numeric LLM-judge score constrained to an integer
  range.
- ``Rank.rank``: rank labeled options per row; options are
  concatenated with label prefixes, output constrained to an array of
  the labels; optional Elo post-pass.
- ``Rank.elo``: rankings -> pairwise win counts (ties shared) ->
  Bradley–Terry strengths via the MM algorithm (Hunter 2004) with
  Laplace smoothing -> Elo scale ``400/ln(10) * ln(strength)`` centered
  at 1500.

pandas is imported only by the methods that take or build a DataFrame
(``rank``, ``elo``); ``rank`` recognises its input through
``sys.modules``. ``rank(server_side=True, compute_elo=True)`` needs
stage graphs (``run_graph``), which the port does not have yet.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..interfaces import BaseSutroClient


class Score(BaseSutroClient):
    def score(
        self,
        data: Any,
        criteria: str,
        column: Optional[Union[str, List[Any]]] = None,
        model: str = "qwen-3-4b",
        min_score: int = 1,
        max_score: int = 10,
        output_column: str = "score",
        job_priority: int = 0,
        **kwargs: Any,
    ) -> Any:
        """LLM-judge numeric score in [min_score, max_score]."""
        if min_score >= max_score:
            raise ValueError("min_score must be < max_score")
        system_prompt = (
            "You are an expert evaluator. Score the user's input according "
            f"to the following criteria:\n{criteria}\n\n"
            f"Respond with an integer score from {min_score} (worst) to "
            f"{max_score} (best)."
        )
        output_schema = {
            "type": "object",
            "properties": {
                "score": {
                    "type": "integer",
                    "enum": list(range(min_score, max_score + 1)),
                }
            },
            "required": ["score"],
        }
        job_id = self.infer(
            data,
            model=model,
            column=column,
            system_prompt=system_prompt,
            output_schema=output_schema,
            job_priority=job_priority,
            stay_attached=False,
            **kwargs,
        )
        if job_id is None:
            return None
        results = self.await_job_completion(job_id, unpack_json=True)
        if results is not None and "score" in results.columns:
            results = results.rename(columns={"score": output_column})
        return results


def _ranking_schema(options: List[str]) -> dict:
    """Schema for a ranked array of ``options``. Up to 5 options it
    constrains to TRUE permutations (<=120 enum alternatives — the FSM
    can afford exact "each label once"); beyond that it falls back to a
    fixed-length label array (repeats possible; the prompt still demands
    uniqueness)."""
    if len(options) <= 5:
        from itertools import permutations

        return {"enum": [list(p) for p in permutations(options)]}
    return {
        "type": "array",
        "items": {"enum": options},
        "minItems": len(options),
        "maxItems": len(options),
    }


class Rank(BaseSutroClient):
    def rank(
        self,
        data: Any,
        options: List[str],
        criteria: str,
        model: str = "qwen-3-4b",
        compute_elo: bool = False,
        output_column: str = "ranking",
        job_priority: int = 0,
        server_side: bool = False,
        **kwargs: Any,
    ) -> Any:
        """Rank ``options`` (column names) for each row against ``criteria``.

        Rows are rendered as label-prefixed sections (reference
        evals.py:130-139); output is constrained to a permutation-ish array
        of the labels.

        ``server_side=True`` with ``compute_elo=True`` submits the rank
        map stage and the Elo reduce as ONE stage-graph job
        (``so.run_graph``): the Elo table is computed inside the engine
        from the rank stage's streamed rows — no client round-trip
        between rank and Elo, one quota/admission draw for the whole
        DAG. Results match the client-side path bit-for-bit at
        temperature 0 (the Elo fit is the same deterministic code),
        except the returned Elo frame has no ``strength`` column."""
        pd = sys.modules.get("pandas")
        if pd is None or not isinstance(data, pd.DataFrame):
            raise ValueError("rank requires a pandas DataFrame input")
        missing = [o for o in options if o not in data.columns]
        if missing:
            raise ValueError(f"options not in DataFrame columns: {missing}")

        concat_parts: List[Any] = []
        for i, opt in enumerate(options):
            prefix = ("\n\n" if i else "") + f"### {opt}:\n"
            concat_parts.extend([prefix, opt])

        system_prompt = (
            "You are an expert evaluator. The user provides several labeled "
            "options. Rank ALL option labels from best to worst according "
            f"to this criteria:\n{criteria}\n\n"
            "Respond with an array of the option labels in ranked order "
            "(best first). Use each label exactly once."
        )
        output_schema = {
            "type": "object",
            "properties": {"ranking": _ranking_schema(options)},
            "required": ["ranking"],
        }
        if compute_elo and server_side:
            job_id = self.run_graph(
                data,
                stages=[
                    {
                        "name": "rank",
                        "kind": "map",
                        "system_prompt": system_prompt,
                        "output_schema": output_schema,
                    },
                    {"name": "elo", "kind": "elo", "after": ["rank"]},
                ],
                model=model,
                column=concat_parts,
                job_priority=job_priority,
                stay_attached=False,
                **kwargs,
            )
            if job_id is None:
                return None
            # the sink (elo) stage's rows ARE the job's results
            elo_df = self.await_job_completion(job_id, unpack_json=True)
            if elo_df is None:
                return None
            # per-row rankings live in the rank stage's own result set
            results = self.get_job_results(
                f"{job_id}/stages/rank", unpack_json=True
            )
            if results is None:
                return None
            if "ranking" in results.columns and output_column != "ranking":
                results = results.rename(columns={"ranking": output_column})
            out = pd.concat(
                [
                    data.reset_index(drop=True),
                    results.reset_index(drop=True),
                ],
                axis=1,
            )
            return out, elo_df
        job_id = self.infer(
            data,
            model=model,
            column=concat_parts,
            system_prompt=system_prompt,
            output_schema=output_schema,
            job_priority=job_priority,
            stay_attached=False,
            **kwargs,
        )
        if job_id is None:
            return None
        results = self.await_job_completion(job_id, unpack_json=True)
        if results is None:
            return None
        if "ranking" in results.columns and output_column != "ranking":
            results = results.rename(columns={"ranking": output_column})
        out = pd.concat(
            [data.reset_index(drop=True), results.reset_index(drop=True)],
            axis=1,
        )
        if compute_elo:
            elo_df = self.elo(out[output_column].tolist())
            return out, elo_df
        return out

    @staticmethod
    def elo(
        rankings: Sequence[Union[str, Sequence[Union[str, Sequence[str]]]]],
        k: float = 400.0,
        base_rating: float = 1500.0,
        iterations: int = 100,
        smoothing: float = 0.1,
    ) -> "pd.DataFrame":
        """Aggregate per-row rankings into Elo ratings via Bradley–Terry
        (``elo_fit``), as a DataFrame with columns ``player``, ``elo``
        and ``strength``, best first."""
        import pandas as pd

        players, elo, strength = elo_fit(
            rankings, k=k, base_rating=base_rating,
            iterations=iterations, smoothing=smoothing,
        )
        if not players:
            return pd.DataFrame(columns=["player", "elo", "strength"])
        return pd.DataFrame(
            {"player": players, "elo": elo, "strength": strength}
        )


def elo_fit(
    rankings: Sequence[Union[str, Sequence[Union[str, Sequence[str]]]]],
    k: float = 400.0,
    base_rating: float = 1500.0,
    iterations: int = 100,
    smoothing: float = 0.1,
) -> Tuple[List[str], List[float], List[float]]:
    """The Bradley–Terry fit behind ``Rank.elo``, without pandas:
    ``(players, elo, strength)`` lists, best first.

    Each ranking is a list of labels best-to-worst; an element may be a
    list of labels to denote a tie group (reference evals.py:225-247).
    Strengths are fit with Hunter's (2004) MM algorithm with Laplace
    smoothing (evals.py:296-308), then mapped to Elo as
    ``base + (400/ln 10) * ln(strength)`` (evals.py:311-313). Equal
    ratings order by player name."""
    wins: Dict[tuple, float] = {}
    players: List[str] = []

    def see(p: str) -> None:
        if p not in players:
            players.append(p)

    for ranking in rankings:
        if isinstance(ranking, str):
            try:
                ranking = json.loads(ranking)
            except ValueError:   # not JSON: the row gives no ranking
                continue
        groups: List[List[str]] = []
        for item in ranking:
            group = [item] if isinstance(item, str) else list(item)
            for p in group:
                see(p)
            groups.append(group)
        for gi, g in enumerate(groups):
            for gj in range(gi + 1, len(groups)):
                for a in g:
                    for b in groups[gj]:
                        wins[(a, b)] = wins.get((a, b), 0.0) + 1.0
            # ties within a group: half-win each way
            for ai, a in enumerate(g):
                for b in g[ai + 1 :]:
                    wins[(a, b)] = wins.get((a, b), 0.0) + 0.5
                    wins[(b, a)] = wins.get((b, a), 0.0) + 0.5

    n = len(players)
    if n == 0:
        return [], [], []
    idx = {p: i for i, p in enumerate(players)}
    W = np.full((n, n), smoothing)
    np.fill_diagonal(W, 0.0)
    for (a, b), w in wins.items():
        W[idx[a], idx[b]] += w

    # Hunter (2004) MM updates: p_i <- sum_j w_ij / sum_j (n_ij/(p_i+p_j))
    p = np.ones(n)
    total_wins = W.sum(axis=1)
    N = W + W.T
    for _ in range(iterations):
        denom = (N / (p[:, None] + p[None, :] + 1e-12)).sum(axis=1)
        p_new = total_wins / np.maximum(denom, 1e-12)
        p_new = p_new / np.exp(np.mean(np.log(p_new + 1e-12)))
        if np.max(np.abs(p_new - p)) < 1e-10:
            p = p_new
            break
        p = p_new

    elo = base_rating + (k / np.log(10.0)) * np.log(p + 1e-12)
    # deterministic tie-break: equal ratings order by player name
    order = sorted(range(n), key=lambda i: (-float(elo[i]), players[i]))
    return (
        [players[i] for i in order],
        [float(elo[i]) for i in order],
        [float(p[i]) for i in order],
    )


class EvalTemplates(Score, Rank):
    pass
