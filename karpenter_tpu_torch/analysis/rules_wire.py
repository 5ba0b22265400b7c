"""Rule guarding the wire codec's enum coverage.

- wire-enum-coverage (the reference's rule over the port's codec): every
  str-enum-typed field across the karpenter_tpu_torch/api dataclasses
  must appear in `codec._ENUM_FIELDS`.
  A bare wire value decodes as `str`, which compares EQUAL to its
  str-enum member, so every selector/taint/phase comparison keeps
  working — until a `.value` access crashes in some error path (the
  differential fuzzer's find, corpus pin seed8505). This rule makes
  that bug class unrepresentable: adding an enum-typed field to
  api/objects.py without registering its coercion fails the lint.
"""

from __future__ import annotations

import ast
import os
from typing import Optional

from karpenter_tpu_torch.analysis.engine import FileContext, Finding, Rule

_CODEC_PATH = "karpenter_tpu_torch/api/codec.py"


def _str_enum_names(tree: ast.Module) -> set[str]:
    """Class names subclassing both `str` and `Enum` (the wire-value
    enums; plain Enums ride the codec's `__enum__` envelope instead)."""
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        bases = set()
        for b in node.bases:
            if isinstance(b, ast.Name):
                bases.add(b.id)
            elif isinstance(b, ast.Attribute):
                bases.add(b.attr)
        if "str" in bases and "Enum" in bases:
            out.add(node.name)
    return out


def _enum_typed_fields(
    tree: ast.Module, enums: set[str]
) -> list[tuple[str, str, str]]:
    """(class, field, enum) for every annotated field whose annotation
    references a str-enum class — including Optional[...] and other
    wrappers (the annotation subtree is walked for enum Names)."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef) or node.name in enums:
            continue
        for stmt in node.body:
            if not isinstance(stmt, ast.AnnAssign) or not isinstance(
                stmt.target, ast.Name
            ):
                continue
            hit = next(
                (
                    sub.id
                    for sub in ast.walk(stmt.annotation)
                    if isinstance(sub, ast.Name) and sub.id in enums
                ),
                None,
            )
            if hit is not None:
                out.append((node.name, stmt.target.id, hit))
    return out


def _enum_fields_literal(
    tree: ast.Module,
) -> tuple[Optional[ast.AST], dict[str, set[str]]]:
    """The `_ENUM_FIELDS` dict literal parsed statically: {class name ->
    registered field names}. Returns (assign node, mapping)."""
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "_ENUM_FIELDS"
            for t in targets
        ):
            continue
        value = node.value
        mapping: dict[str, set[str]] = {}
        if isinstance(value, ast.Dict):
            for k, v in zip(value.keys, value.values):
                if not (
                    isinstance(k, ast.Constant) and isinstance(k.value, str)
                ):
                    continue
                fields = set()
                if isinstance(v, ast.Dict):
                    fields = {
                        fk.value
                        for fk in v.keys
                        if isinstance(fk, ast.Constant)
                        and isinstance(fk.value, str)
                    }
                mapping[k.value] = fields
        return node, mapping
    return None, {}


class WireEnumCoverageRule(Rule):
    id = "wire-enum-coverage"
    summary = (
        "every str-enum-typed field in karpenter_tpu_torch/api dataclasses "
        "must be registered in codec._ENUM_FIELDS (seed8505 bug class)"
    )
    targets = (_CODEC_PATH,)

    def check(self, ctx: FileContext) -> list[Finding]:
        assign, registered = _enum_fields_literal(ctx.tree)
        if assign is None:
            return [
                ctx.finding(
                    self.id,
                    1,
                    "codec has no statically-parsable _ENUM_FIELDS dict "
                    "literal — the decode-time enum coercion table is the "
                    "wire contract this rule polices",
                )
            ]
        objects_path = os.path.join(os.path.dirname(ctx.path), "objects.py")
        try:
            with open(objects_path, encoding="utf-8") as f:
                objects_tree = ast.parse(f.read(), filename=objects_path)
        except (OSError, SyntaxError) as e:
            return [
                ctx.finding(
                    self.id,
                    assign,
                    f"cannot parse sibling objects.py ({type(e).__name__}: "
                    f"{e}) — enum coverage is unverifiable",
                )
            ]
        enums = _str_enum_names(objects_tree)
        out = []
        for cls, field, enum_name in _enum_typed_fields(objects_tree, enums):
            if field not in registered.get(cls, set()):
                out.append(
                    ctx.finding(
                        self.id,
                        assign,
                        f"{cls}.{field} is typed {enum_name} (a str enum) "
                        "but missing from _ENUM_FIELDS — it would decode "
                        "as bare str and crash on .value access (seed8505)",
                    )
                )
        return out


RULES = (WireEnumCoverageRule,)
