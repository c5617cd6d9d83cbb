"""Stdlib AST linter — the repo's `make lint` gate.

The reference CI lints with clippy `-D warnings` (cargo.yml:27-36); no
ruff/flake8/pyflakes is assumed installed, so this is a from-scratch
checker built on `ast` + `tokenize` implementing the highest-value subset:

  F401  unused import
  F403  star import
  F811  redefinition of an imported name by another import
  F632  `is` comparison against a str/number literal
  E501  line too long (>100; the repo wraps at ~79 but long citation URLs
        and table comments get slack)
  E711  == / != comparison against None
  E712  == / != comparison against True/False
  E722  bare `except:`
  B006  mutable default argument (list/dict/set literals)
  B011  `assert False` (use raise)
  W291  trailing whitespace
  W605  invalid escape sequence in a non-raw string literal
  F541  f-string with no placeholders

Every rule can be silenced per line with `# lint: ignore[CODE]` or per
file via the IGNORE table below. Exit code 1 on any finding (CI gate).
"""
from __future__ import annotations

import ast
import io
import sys
import tokenize
from pathlib import Path

MAX_LINE = 100

# (path-suffix, code) pairs exempted with a reason:
IGNORE = {
    # conftest must set XLA_FLAGS before importing jax — imports are used
    # for their side effects mid-file
    ("tests/conftest.py", "E402"),
}


class Finding:
    def __init__(self, path, line, code, msg):
        self.path, self.line, self.code, self.msg = path, line, code, msg

    def __str__(self):
        return f"{self.path}:{self.line}: {self.code} {self.msg}"


def _ignored(src_lines, lineno, code):
    if 1 <= lineno <= len(src_lines):
        line = src_lines[lineno - 1]
        if f"lint: ignore[{code}]" in line or "lint: ignore-all" in line:
            return True
    return False


class Checker(ast.NodeVisitor):
    def __init__(self, path, src_lines):
        self.path = path
        self.lines = src_lines
        self.findings = []
        self.imports = {}      # name -> lineno (module scope)
        self.used = set()
        self._depth = 0
        self._in_try = 0

    def add(self, node, code, msg):
        if not _ignored(self.lines, node.lineno, code):
            self.findings.append(Finding(self.path, node.lineno, code, msg))

    # --- imports (module scope only: function-local late imports are a
    # deliberate pattern here — trace-time imports keep module import
    # light — and live in their own scope, so F401/F811 don't apply) ----
    def visit_Try(self, node):
        # version-fallback imports (try: from jax import X / except:
        # from old import X) are deliberate redefinitions, not F811
        self._in_try += 1
        self.generic_visit(node)
        self._in_try -= 1

    def visit_Import(self, node):
        if self._depth == 0:
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                if name in self.imports and not self._in_try:
                    self.add(node, "F811",
                             f"redefinition of import `{name}`")
                self.imports[name] = node.lineno
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        for a in node.names:
            if a.name == "*":
                self.add(node, "F403", "star import")
        if node.module == "__future__" or self._depth:
            self.generic_visit(node)
            return
        for a in node.names:
            if a.name == "*":
                continue
            name = a.asname or a.name
            if name in self.imports and not self._in_try:
                self.add(node, "F811", f"redefinition of import `{name}`")
            self.imports[name] = node.lineno
        self.generic_visit(node)

    def visit_Name(self, node):
        self.used.add(node.id)
        self.generic_visit(node)

    def visit_Attribute(self, node):
        # record the root name of dotted uses (np.foo -> np)
        n = node
        while isinstance(n, ast.Attribute):
            n = n.value
        if isinstance(n, ast.Name):
            self.used.add(n.id)
        self.generic_visit(node)

    # --- comparisons ---------------------------------------------------
    def visit_Compare(self, node):
        for op, right in zip(node.ops, node.comparators):
            if isinstance(op, (ast.Eq, ast.NotEq)):
                if isinstance(right, ast.Constant) and right.value is None:
                    self.add(node, "E711", "comparison to None (use `is`)")
                elif isinstance(right, ast.Constant) and isinstance(
                        right.value, bool):
                    self.add(node, "E712", "comparison to bool (use the "
                             "value or `is`)")
            if isinstance(op, (ast.Is, ast.IsNot)):
                if isinstance(right, ast.Constant) and isinstance(
                        right.value, (str, int, float)) and not isinstance(
                        right.value, bool):
                    self.add(node, "F632", "`is` against a literal")
        self.generic_visit(node)

    # --- handlers / defaults / asserts ---------------------------------
    def visit_ExceptHandler(self, node):
        if node.type is None:
            self.add(node, "E722", "bare `except:`")
        self.generic_visit(node)

    def _check_defaults(self, node):
        for d in node.args.defaults + node.args.kw_defaults:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                self.add(d, "B006", "mutable default argument")

    def visit_FunctionDef(self, node):
        self._check_defaults(node)
        self._depth += 1
        self.generic_visit(node)
        self._depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assert(self, node):
        if isinstance(node.test, ast.Constant) and node.test.value is False:
            self.add(node, "B011", "`assert False` (raise instead)")
        self.generic_visit(node)

    def visit_FormattedValue(self, node):
        # don't recurse into format_spec (itself a JoinedStr of constants)
        self.visit(node.value)

    def visit_JoinedStr(self, node):
        if not any(isinstance(v, ast.FormattedValue) for v in node.values):
            self.add(node, "F541", "f-string without placeholders")
        self.generic_visit(node)

    def finish(self, tree):
        # __all__ marks re-exports; so does any string use in docstrings?
        # keep it simple: names listed in __all__ count as used
        for node in ast.walk(tree):
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in node.targets)
                    and isinstance(node.value, (ast.List, ast.Tuple))):
                for e in node.value.elts:
                    if isinstance(e, ast.Constant):
                        self.used.add(e.value)
        init = self.path.name == "__init__.py"
        for name, lineno in self.imports.items():
            if name not in self.used and not init and name != "_":
                if not _ignored(self.lines, lineno, "F401"):
                    self.findings.append(Finding(
                        self.path, lineno, "F401",
                        f"unused import `{name}`"))


def check_file(path: Path):
    src = path.read_text()
    lines = src.splitlines()
    findings = []
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "E999", f"syntax error: {e.msg}")]
    c = Checker(path, lines)
    c.visit(tree)
    c.finish(tree)
    findings += c.findings

    for i, line in enumerate(lines, 1):
        if line != line.rstrip() and "lint: ignore" not in line:
            findings.append(Finding(path, i, "W291", "trailing whitespace"))
        if len(line) > MAX_LINE and "lint: ignore" not in line:
            findings.append(Finding(path, i, "E501",
                                    f"line too long ({len(line)})"))

    # W605: invalid escapes surface as SyntaxWarning under -W error; cheap
    # proxy — scan string tokens for \<char> outside the sanctioned set
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type != tokenize.STRING:
                continue
            text = tok.string
            prefix = text[:text.index(text[-1] * (3 if text.endswith(
                text[-1] * 3) else 1))].lower() if text else ""
            if "r" in prefix or "b" in prefix:
                continue
            body = text
            i = 0
            while i < len(body) - 1:
                if body[i] == "\\":
                    nxt = body[i + 1]
                    if nxt not in "\\'\"abfnrtv0xuUN\n123456789{}":
                        findings.append(Finding(
                            path, tok.start[0], "W605",
                            f"invalid escape `\\{nxt}`"))
                    i += 2
                else:
                    i += 1
    except tokenize.TokenError:
        pass

    findings = [f for f in findings
                if not any(str(f.path).endswith(sfx) and f.code == code
                           for sfx, code in IGNORE)]
    return findings


def main(argv):
    roots = argv or ["raytracer", "tests", "tools", "chip_smoke.py",
                     "bench.py", "__graft_entry__.py"]
    files = []
    for r in roots:
        p = Path(r)
        files += sorted(p.rglob("*.py")) if p.is_dir() else [p]
    all_findings = []
    for f in files:
        all_findings += check_file(f)
    for f in all_findings:
        print(f)
    print(f"lint: {len(files)} files, {len(all_findings)} findings")
    return 1 if all_findings else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
