"""The port's declaration registry (``predictionio_tpu_torch/common/
declarations.py``) against the reference's: every reference name with
the reference's one-liner, exactly the port's own names besides, the
same journal categories plus the port's own, and the knob table derived
from it."""

import ast
import os

import pytest

from predictionio_tpu.common import declarations as ref
from predictionio_tpu_torch import knobs
from predictionio_tpu_torch.common import declarations as port
from predictionio_tpu_torch.tools.analyze.passes import (
    declarations as decl_pass,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the port's own names, which have no reference counterpart
PORT_ENV = {"PIO_TORCH_DEVICE", "PIO_TORCH_KERNEL_DIR"}
PORT_METRICS = {"pio_eventlog_chunk_map_fallbacks_total"}
PORT_CATEGORIES = {"eventlog"}


@pytest.mark.parametrize("name", ["ENV_VARS", "METRICS",
                                  "JOURNAL_CATEGORIES"])
def test_the_registry_holds_every_reference_name_and_its_text(name):
    mine, theirs = getattr(port, name), getattr(ref, name)
    assert set(theirs) <= set(mine)
    for key, text in theirs.items():
        # the reference's words first; a port note may follow
        assert (mine[key] == text
                or mine[key].startswith(text + "; the port:")), key


def test_the_extra_names_are_exactly_the_ports_own():
    assert set(port.ENV_VARS) - set(ref.ENV_VARS) == PORT_ENV
    assert set(port.METRICS) - set(ref.METRICS) == PORT_METRICS
    assert (set(port.JOURNAL_CATEGORIES) - set(ref.JOURNAL_CATEGORIES)
            == PORT_CATEGORIES)
    assert port.PORT_ONLY == PORT_ENV | PORT_METRICS | PORT_CATEGORIES
    assert len(port.ENV_VARS) == 120 and len(port.METRICS) == 87


def test_journal_categories_are_the_references_and_eventlog():
    mine = {k: v for k, v in port.JOURNAL_CATEGORIES.items()
            if k not in port.PORT_ONLY}
    assert mine == ref.JOURNAL_CATEGORIES


def test_every_inert_or_refused_knob_says_so():
    for name, knob in knobs.KNOBS.items():
        text = port.ENV_VARS[name]
        if knob.kind == knobs.INERT:
            assert "the port: INERT" in text, name
        elif knob.kind == knobs.UNPORTED:
            assert "the port: REFUSED" in text, name
        else:
            assert "INERT" not in text and "REFUSED" not in text, name


def test_knobs_are_the_registry_less_the_ports_own():
    assert set(knobs.KNOBS) == set(port.ENV_VARS) - port.PORT_ONLY
    assert set(knobs.KNOBS) == set(ref.ENV_VARS)
    for name, knob in knobs.KNOBS.items():
        if knob.kind == knobs.READ:
            assert knob.what == port.ENV_VARS[name], name


def test_the_lint_reads_the_same_registry_it_imports():
    """The pass parses the module's AST; it must see exactly what an
    import sees, so a non-literal entry cannot hide a name."""
    path = os.path.join(REPO, "predictionio_tpu_torch", "common",
                        "declarations.py")
    with open(path, encoding="utf-8") as f:
        read = decl_pass.read_registry(ast.parse(f.read()))
    assert read == {"ENV_VARS": port.ENV_VARS, "METRICS": port.METRICS,
                    "JOURNAL_CATEGORIES": port.JOURNAL_CATEGORIES}


@pytest.mark.parametrize("src,match", [
    ("ENV_VARS = {**{}}\nMETRICS = {}\nJOURNAL_CATEGORIES = {}\n",
     "not a string literal"),
    ("ENV_VARS = dict()\nMETRICS = {}\nJOURNAL_CATEGORIES = {}\n",
     "not a dict literal"),
    ("ENV_VARS = {}\nMETRICS = {}\n", "no JOURNAL_CATEGORIES"),
])
def test_a_registry_the_lint_cannot_read_is_an_error(src, match):
    with pytest.raises(ValueError, match=match):
        decl_pass.read_registry(ast.parse(src))
