"""Dataset format converters (port of
``llm_in_practise_tpu/data/converters.py``, a copy).

Self-cognition JSONL records (``query`` / ``response`` with ``{{NAME}}``
/ ``{{AUTHOR}}`` placeholders) to alpaca JSON (``instruction`` /
``input`` / ``output``), and an alpaca record to chat messages for the
SFT pipeline.

    python -m llm_in_practise_tpu_torch.data.converters IN.jsonl OUT.json \\
        --name MyBot --author MyTeam
"""

from __future__ import annotations

import json
from typing import Iterable

from llm_in_practise_tpu_torch.data.sft import substitute_placeholders


def self_cognition_to_alpaca(records: Iterable[dict], *, name: str,
                             author: str) -> list[dict]:
    return [
        {"instruction": str(r.get("query", "")), "input": "",
         "output": str(r.get("response", ""))}
        for r in substitute_placeholders(list(records), name, author)
    ]


def convert_file(in_path: str, out_path: str, *, name: str,
                 author: str) -> int:
    """JSONL in, alpaca JSON out; returns the record count."""
    records = []
    with open(in_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    converted = self_cognition_to_alpaca(records, name=name, author=author)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(converted, f, ensure_ascii=False, indent=2)
    return len(converted)


def alpaca_to_messages(record: dict, system_prompt: str | None = None
                       ) -> list[dict]:
    """One alpaca record -> OpenAI-style messages."""
    user = record.get("instruction", "")
    if record.get("input"):
        user = f"{user}\n{record['input']}"
    msgs = []
    if system_prompt:
        msgs.append({"role": "system", "content": system_prompt})
    msgs.append({"role": "user", "content": user})
    msgs.append({"role": "assistant", "content": record.get("output", "")})
    return msgs


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--name", required=True)
    p.add_argument("--author", required=True)
    a = p.parse_args()
    n = convert_file(a.input, a.output, name=a.name, author=a.author)
    print(f"converted {n} records -> {a.output}")
