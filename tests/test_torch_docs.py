"""The port's docs cannot rot: every fenced ```python block of
docs/torch_api.md executes, in order, in one namespace, as
tests/test_docs.py runs the JAX package's documents.

The same conventions: ```python blocks are executed cumulatively, top to
bottom; a block whose first line contains ``doc-only`` is skipped; other
fences are never executed.
"""
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
DOC = ROOT / "docs" / "torch_api.md"

_FENCE = re.compile(r"^```python[ \t]*$(.*?)^```[ \t]*$",
                    re.MULTILINE | re.DOTALL)


def python_blocks(path: pathlib.Path):
    text = path.read_text()
    blocks = []
    for m in _FENCE.finditer(text):
        code = m.group(1).strip("\n")
        first = code.splitlines()[0] if code else ""
        if "doc-only" in first:
            continue
        line = text[:m.start()].count("\n") + 2  # 1-based, after the fence
        blocks.append((line, code))
    return blocks


def test_doc_exists_and_has_executable_examples():
    assert DOC.exists(), f"missing documentation file {DOC}"
    assert len(python_blocks(DOC)) >= 4


def test_doc_snippets_execute(tmp_path):
    """Execute the document's python blocks in one shared namespace, like a
    reader pasting them into a REPL top to bottom; the engine's
    configuration is put back afterwards."""
    from repro_torch.storage import registry

    saved = dict(registry._CONF)
    registry.set_conf(data_dir=str(tmp_path / "fm-docs"))
    ns: dict = {"__name__": "doc_torch_api"}
    try:
        for line, code in python_blocks(DOC):
            try:
                exec(compile(code, f"{DOC.name}:{line}", "exec"), ns)
            except Exception as e:  # pragma: no cover - failure reporting
                pytest.fail(
                    f"{DOC.name} snippet at line {line} failed: "
                    f"{type(e).__name__}: {e}\n--- snippet ---\n{code}")
    finally:
        registry._CONF.clear()
        registry._CONF.update(saved)
