"""The kernel sweep's variants: each changes the shipped package only
where it says, so a timing of a variant is a timing of that one change."""

import filecmp

import pytest

import kernel_sweep


def _differing(a, b, rel=""):
    cmp = filecmp.dircmp(a / rel, b / rel, ignore=["__pycache__"])
    assert not cmp.left_only and not cmp.right_only
    files = {f"{rel}/{f}".lstrip("/") for f in cmp.diff_files}
    for sub in cmp.common_dirs:
        files |= _differing(a, b, f"{rel}/{sub}".lstrip("/"))
    return files


@pytest.mark.parametrize("name", list(kernel_sweep.VARIANTS))
def test_variant_changes_only_its_lines(name, tmp_path):
    edits = kernel_sweep.VARIANTS[name]
    dest = kernel_sweep.make_variant(name, edits, into=tmp_path)
    tree = kernel_sweep.ROOT / kernel_sweep.PACKAGE
    copy = dest / kernel_sweep.PACKAGE
    assert _differing(tree, copy) == {rel for rel, _, _ in edits}
    for rel, old, new in edits:
        # the shipped line is there once, and the variant's in its place
        assert (tree / rel).read_text().count(old) == 1
        assert new in (copy / rel).read_text() and old not in (copy / rel).read_text()
