"""The suite's ``slow`` marks come from one table, ``SLOW`` of the root
``conftest.py``, and each entry names a test that exists, with its reason.

The tier-1 run deselects ``-m 'not slow'``, so a mark takes a test out of
every routine run; no test file may carry one of its own.
"""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _table(config):
    """The root conftest.py as pytest loaded it for this run."""
    for plugin in config.pluginmanager.get_plugins():
        if getattr(plugin, "__file__", None) == str(ROOT / "conftest.py"):
            return plugin
    raise AssertionError("the root conftest.py is not loaded")


def test_each_slow_entry_names_a_test_and_its_reason(pytestconfig):
    slow = _table(pytestconfig).SLOW
    assert slow
    for nodeid, reason in slow.items():
        path, name = nodeid.split("::")
        tree = ast.parse((ROOT / path).read_text())
        assert name in {n.name for n in tree.body
                        if isinstance(n, ast.FunctionDef)}, nodeid
        assert reason.strip() and "\n" not in reason, nodeid


def test_only_the_table_marks_tests_slow(pytestconfig):
    table = _table(pytestconfig)

    class Item:
        def __init__(self, nodeid):
            self.nodeid, self.marks = nodeid, []

        def add_marker(self, mark):
            self.marks.append(mark.name)

    items = [Item(n) for n in [*table.SLOW, "tests/test_frame.py::other"]]
    table.pytest_collection_modifyitems(pytestconfig, items)
    assert [i.marks for i in items] == [["slow"]] * len(table.SLOW) + [[]]

    here = Path(__file__).resolve()
    marked = [p.name for p in sorted(ROOT.glob("tests/**/*.py"))
              if p != here and "mark.slow" in p.read_text()]
    assert marked == []
