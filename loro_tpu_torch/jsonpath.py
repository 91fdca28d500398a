"""JSONPath queries over live documents + subscriptions.

reference: crates/loro-internal/src/jsonpath/ (jsonpath.pest grammar,
parser.rs, jsonpath_impl.rs evaluator, subscription.rs).  The full
grammar is supported (recursive-descent parser mirroring the pest
rules, not a translation):

  $                         root
  .key  ['key']  ["key"]    member access (string escapes incl. \\uXXXX)
  [0]  [-1]                 index access (negative from end)
  [s:e]  [s:e:st]           slices (negative step supported)
  .*  [*]                   wildcard
  ..key  ..*  ..[...]       recursive descent
  [sel, sel, ...]           unions of ANY selectors (names, indexes,
                            slices, wildcards, filters)
  [? expr]  [?(expr)]       filters: comparisons (==, !=, <, <=, >, >=,
                            contains, in), existence tests (?@.k),
                            logical && || !, parentheses, literals
                            (numbers, strings, true/false/null, arrays),
                            nested queries from @ or $, and the
                            standard functions length(), count(),
                            value(), match(), search()
Results are deep values (container contents resolve recursively).
"""
from __future__ import annotations

import re as _re
from typing import Any, Callable, List, Optional, Tuple

from .doc import LoroDoc, LoroError


class JsonPathError(LoroError):
    pass


_NOTHING = object()  # absent value (RFC 9535 "Nothing")

_NAME_FIRST = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_NAME_CHARS = _NAME_FIRST | set("0123456789")


# ---------------------------------------------------------------------------
# parsing (recursive descent over the pest grammar's shape)
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    # -- low-level ----------------------------------------------------
    def err(self, msg: str) -> JsonPathError:
        return JsonPathError(f"{msg} at {self.i}: {self.s[self.i : self.i + 20]!r}")

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def starts(self, tok: str) -> bool:
        return self.s.startswith(tok, self.i)

    def eat(self, tok: str) -> bool:
        if self.starts(tok):
            self.i += len(tok)
            return True
        return False

    def expect(self, tok: str) -> None:
        if not self.eat(tok):
            raise self.err(f"expected {tok!r}")

    def ws(self) -> None:
        while self.peek() and self.peek() in " \t\n\r":
            self.i += 1

    # -- names / literals ---------------------------------------------
    def member_name(self) -> str:
        start = self.i
        c = self.peek()
        if c not in _NAME_FIRST and not (c and ord(c) >= 0x80):
            raise self.err("expected member name")
        self.i += 1
        while True:
            c = self.peek()
            if c in _NAME_CHARS or (c and ord(c) >= 0x80):
                self.i += 1
            else:
                break
        return self.s[start : self.i]

    def string_literal(self) -> str:
        quote = self.peek()
        assert quote in "'\""
        self.i += 1
        out: List[str] = []
        while True:
            c = self.peek()
            if not c:
                raise self.err("unterminated string")
            if c == quote:
                self.i += 1
                return "".join(out)
            if c == "\\":
                self.i += 1
                e = self.peek()
                self.i += 1
                mapped = {
                    "b": "\b", "f": "\f", "n": "\n", "r": "\r", "t": "\t",
                    "/": "/", "\\": "\\", "'": "'", '"': '"',
                }.get(e)
                if mapped is not None:
                    out.append(mapped)
                elif e == "u":
                    hex4 = self.s[self.i : self.i + 4]
                    if len(hex4) != 4 or any(h not in "0123456789abcdefABCDEF" for h in hex4):
                        raise self.err("bad \\u escape")
                    self.i += 4
                    cp = int(hex4, 16)
                    if 0xD800 <= cp <= 0xDBFF and self.s.startswith("\\u", self.i):
                        lo4 = self.s[self.i + 2 : self.i + 6]
                        if len(lo4) == 4:
                            lo = int(lo4, 16)
                            if 0xDC00 <= lo <= 0xDFFF:
                                self.i += 6
                                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00)
                    out.append(chr(cp))
                else:
                    raise self.err(f"bad escape \\{e}")
            else:
                out.append(c)
                self.i += 1

    def int_literal(self) -> Optional[int]:
        start = self.i
        self.eat("-")
        if not self.peek().isdigit():
            self.i = start
            return None
        while self.peek().isdigit():
            self.i += 1
        return int(self.s[start : self.i])

    def number_literal(self) -> Any:
        start = self.i
        if self.int_literal() is None:
            raise self.err("expected number")
        is_float = False
        if self.peek() == "." and self.s[self.i + 1 : self.i + 2].isdigit():
            is_float = True
            self.i += 1
            while self.peek().isdigit():
                self.i += 1
        if self.peek() in "eE":
            is_float = True
            self.i += 1
            if self.peek() in "+-":
                self.i += 1
            if not self.peek().isdigit():
                raise self.err("bad exponent")
            while self.peek().isdigit():
                self.i += 1
        text = self.s[start : self.i]
        return float(text) if is_float else int(text)

    # -- path ---------------------------------------------------------
    def parse_path(self) -> List[Tuple]:
        self.ws()
        self.expect("$")
        steps = self.parse_segments()
        self.ws()
        if self.i != len(self.s):
            raise self.err("trailing input")
        return steps

    def parse_segments(self) -> List[Tuple]:
        """Segments until something that isn't a segment start."""
        steps: List[Tuple] = []
        while True:
            self.ws()
            if self.starts(".."):
                self.i += 2
                if self.peek() == "[":
                    steps.append(("recursive_step", self.bracketed()))
                elif self.eat("*"):
                    steps.append(("recursive_step", ("select", (("wild",),))))
                else:
                    steps.append(("recursive_step", ("select", (("key", self.member_name()),))))
            elif self.peek() == ".":
                self.i += 1
                if self.eat("*"):
                    steps.append(("select", (("wild",),)))
                else:
                    steps.append(("select", (("key", self.member_name()),)))
            elif self.peek() == "[":
                steps.append(self.bracketed())
            else:
                return steps

    def bracketed(self) -> Tuple:
        self.expect("[")
        sels = [self.selector()]
        self.ws()
        while self.eat(","):
            self.ws()
            sels.append(self.selector())
            self.ws()
        self.expect("]")
        return ("select", tuple(sels))

    def selector(self) -> Tuple:
        self.ws()
        c = self.peek()
        if c == "*":
            self.i += 1
            return ("wild",)
        if c and c in "'\"":
            return ("key", self.string_literal())
        if c == "?":
            self.i += 1
            self.ws()
            return ("filter", self.logical_or())
        # slice or index
        start = self.int_literal()
        self.ws()
        if self.peek() == ":":
            self.i += 1
            self.ws()
            stop = self.int_literal()
            self.ws()
            step = None
            if self.eat(":"):
                self.ws()
                step = self.int_literal()
            if step == 0:
                raise self.err("slice step cannot be 0")
            return ("slice", start, stop, step)
        if start is None:
            raise self.err("expected selector")
        return ("index", start)

    # -- filter expressions -------------------------------------------
    def logical_or(self) -> Tuple:
        terms = [self.logical_and()]
        while True:
            self.ws()
            if not self.eat("||"):
                break
            terms.append(self.logical_and())
        return terms[0] if len(terms) == 1 else ("or", tuple(terms))

    def logical_and(self) -> Tuple:
        terms = [self.basic_expr()]
        while True:
            self.ws()
            if not self.eat("&&"):
                break
            terms.append(self.basic_expr())
        return terms[0] if len(terms) == 1 else ("and", tuple(terms))

    def basic_expr(self) -> Tuple:
        self.ws()
        neg = False
        while self.eat("!"):
            neg = not neg
            self.ws()
        if self.eat("("):
            inner = self.logical_or()
            self.ws()
            self.expect(")")
            expr = inner
            # a paren group may still be the left side of a comparison?
            # grammar says no (paren_expr is a basic_expr) — keep as-is
        else:
            expr = self.comparison_or_test()
        return ("not", expr) if neg else expr

    def comparison_or_test(self) -> Tuple:
        left = self.comparable()
        self.ws()
        for op in ("==", "!=", "<=", ">=", "<", ">", "contains", "in"):
            if self.starts(op):
                # word ops need a boundary so keys like "interest" are safe
                end = self.i + len(op)
                if op.isalpha() and end < len(self.s) and self.s[end] in _NAME_CHARS:
                    continue
                self.i = end
                self.ws()
                right = self.comparable()
                return ("cmp", op, left, right)
        # bare test: must be a query or function, not a literal
        if left[0] not in ("query", "func"):
            raise self.err("literal is not a valid filter test")
        return ("test", left)

    def comparable(self) -> Tuple:
        self.ws()
        c = self.peek()
        if c and c in "'\"":
            return ("lit", self.string_literal())
        if c == "@" or c == "$":
            self.i += 1
            kind = "rel" if c == "@" else "abs"
            return ("query", kind, tuple(self.parse_segments()))
        if c == "[":  # array literal
            self.i += 1
            items: List[Any] = []
            self.ws()
            if not self.eat("]"):
                while True:
                    lit = self.comparable()
                    if lit[0] != "lit":
                        raise self.err("array literals hold literals only")
                    items.append(lit[1])
                    self.ws()
                    if self.eat("]"):
                        break
                    self.expect(",")
                    self.ws()
            return ("lit", items)
        if self.starts("true") :
            self.i += 4
            return ("lit", True)
        if self.starts("false"):
            self.i += 5
            return ("lit", False)
        if self.starts("null"):
            self.i += 4
            return ("lit", None)
        if c.isdigit() or c == "-":
            return ("lit", self.number_literal())
        if c in _NAME_FIRST:
            save = self.i
            name = self.member_name()
            self.ws()
            if self.eat("("):
                args: List[Tuple] = []
                self.ws()
                if not self.eat(")"):
                    while True:
                        args.append(self.comparable())
                        self.ws()
                        if self.eat(")"):
                            break
                        self.expect(",")
                return ("func", name, tuple(args))
            self.i = save
            raise self.err(f"bare name {name!r} is not a comparable")
        raise self.err("expected comparable")


def parse(path: str) -> List[Tuple]:
    """Parse into a list of step tuples (raises JsonPathError)."""
    if not path:
        raise JsonPathError("empty path")
    return _Parser(path).parse_path()


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def _children(v: Any) -> List[Any]:
    if isinstance(v, dict):
        return list(v.values())
    if isinstance(v, list):
        return list(v)
    return []


def _descendants(v: Any) -> List[Any]:
    out = [v]
    stack = [v]
    while stack:
        cur = stack.pop()
        for c in _children(cur):
            out.append(c)
            stack.append(c)
    return out


def _cmp_ok(a: Any, b: Any) -> bool:
    num = isinstance(a, (int, float)) and not isinstance(a, bool)
    numb = isinstance(b, (int, float)) and not isinstance(b, bool)
    return (num and numb) or (isinstance(a, str) and isinstance(b, str))


def _strict_eq(a: Any, b: Any) -> bool:
    """JSON-typed equality: bools never equal numbers (Python's
    True == 1 would diverge from the reference's serde_json values)."""
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_strict_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_strict_eq(v, b[k]) for k, v in a.items())
    return a == b


def _eval_cmp(op: str, a: Any, b: Any) -> bool:
    if op == "==":
        if a is _NOTHING or b is _NOTHING:
            return a is b
        return _strict_eq(a, b)
    if op == "!=":
        return not _eval_cmp("==", a, b)
    if a is _NOTHING or b is _NOTHING:
        return False
    if op == "contains":
        if isinstance(a, list):
            return any(_strict_eq(x, b) for x in a)
        if isinstance(a, str) and isinstance(b, str):
            return b in a
        return False
    if op == "in":
        return _eval_cmp("contains", b, a)
    if not _cmp_ok(a, b):
        return False
    return {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b}[op]


def _apply_selector(sel: Tuple, v: Any, root: Any) -> List[Any]:
    kind = sel[0]
    if kind == "key":
        if isinstance(v, dict) and sel[1] in v:
            return [v[sel[1]]]
        return []
    if kind == "index":
        if isinstance(v, list) and -len(v) <= sel[1] < len(v):
            return [v[sel[1]]]
        return []
    if kind == "slice":
        if isinstance(v, list):
            return v[sel[1] : sel[2] : sel[3]]
        return []
    if kind == "wild":
        return _children(v)
    if kind == "filter":
        return [c for c in _children(v) if _truthy(_eval_expr(sel[1], c, root))]
    raise JsonPathError(f"unknown selector {sel}")  # pragma: no cover


def _apply_step(nodes: List[Any], step: Tuple, root: Any) -> List[Any]:
    out: List[Any] = []
    if step[0] == "select":
        for v in nodes:
            for sel in step[1]:
                out.extend(_apply_selector(sel, v, root))
        return out
    if step[0] == "recursive_step":
        inner = step[1]
        for v in nodes:
            for d in _descendants(v):
                out.extend(_apply_step([d], inner, root))
        return out
    raise JsonPathError(f"unknown step {step}")  # pragma: no cover


def _eval_query(q: Tuple, current: Any, root: Any) -> List[Any]:
    _, kind, segments = q
    nodes = [current if kind == "rel" else root]
    for step in segments:
        nodes = _apply_step(nodes, step, root)
    return nodes


def _singular(v: Tuple, current: Any, root: Any) -> Any:
    """Comparable -> value or _NOTHING."""
    if v[0] == "lit":
        return v[1]
    if v[0] == "query":
        nodes = _eval_query(v, current, root)
        return nodes[0] if len(nodes) == 1 else _NOTHING
    if v[0] == "func":
        return _eval_func(v, current, root)
    raise JsonPathError(f"bad comparable {v}")  # pragma: no cover


def _eval_func(f: Tuple, current: Any, root: Any) -> Any:
    _, name, args = f

    def arg_value(i: int) -> Any:
        return _singular(args[i], current, root)

    if name == "length" and len(args) == 1:
        v = arg_value(0)
        if isinstance(v, (str, list, dict)):
            return len(v)
        return _NOTHING
    if name == "count" and len(args) == 1 and args[0][0] == "query":
        return len(_eval_query(args[0], current, root))
    if name == "value" and len(args) == 1 and args[0][0] == "query":
        nodes = _eval_query(args[0], current, root)
        return nodes[0] if len(nodes) == 1 else _NOTHING
    if name in ("match", "search") and len(args) == 2:
        s = arg_value(0)
        pat = arg_value(1)
        if not isinstance(s, str) or not isinstance(pat, str):
            return False
        try:
            rx = _re.compile(pat)
        except _re.error:
            raise JsonPathError(f"bad regex {pat!r}")
        return bool(rx.fullmatch(s) if name == "match" else rx.search(s))
    raise JsonPathError(f"unknown function {name}/{len(args)}")


def _truthy(v: Any) -> bool:
    if v is _NOTHING:
        return False
    return bool(v)


def _eval_expr(e: Tuple, current: Any, root: Any) -> Any:
    kind = e[0]
    if kind == "or":
        return any(_truthy(_eval_expr(t, current, root)) for t in e[1])
    if kind == "and":
        return all(_truthy(_eval_expr(t, current, root)) for t in e[1])
    if kind == "not":
        return not _truthy(_eval_expr(e[1], current, root))
    if kind == "cmp":
        # existential comparison over query nodelists (reference
        # jsonpath_impl.rs compare_expr: any node pair may satisfy;
        # empty nodelists never do — even for ==)
        _, op, left, right = e

        def operand(v):
            if v[0] == "query":
                return "nodes", _eval_query(v, current, root)
            return "val", _singular(v, current, root)

        lk, lv = operand(left)
        rk, rv = operand(right)
        if lk == "nodes" and rk == "nodes":
            return any(_eval_cmp(op, a, b) for a in lv for b in rv)
        if lk == "nodes":
            return any(_eval_cmp(op, a, rv) for a in lv)
        if rk == "nodes":
            return any(_eval_cmp(op, lv, b) for b in rv)
        return _eval_cmp(op, lv, rv)
    if kind == "test":
        inner = e[1]
        if inner[0] == "query":
            return bool(_eval_query(inner, current, root))
        return _truthy(_eval_func(inner, current, root))
    raise JsonPathError(f"unknown expr {e}")  # pragma: no cover


def _eval_steps(doc: LoroDoc, steps: List[Tuple]) -> List[Any]:
    root: Any = doc.get_deep_value()
    nodes: List[Any] = [root]
    for step in steps:
        nodes = _apply_step(nodes, step, root)
    return nodes


def query(doc: LoroDoc, path: str) -> List[Any]:
    """Evaluate a JSONPath against the doc's deep value.
    reference API: loro.rs jsonpath / loro/src/lib.rs:1358."""
    return _eval_steps(doc, parse(path))


def subscribe_jsonpath(
    doc: LoroDoc, path: str, cb: Callable[[List[Any]], None]
) -> Callable[[], None]:
    """Re-evaluate on every doc event; callback fires when the result
    set changes (reference: jsonpath/subscription.rs)."""
    steps = parse(path)  # parse ONCE; events re-evaluate, not re-parse
    last: List[Any] = _eval_steps(doc, steps)

    def on_event(_ev) -> None:
        nonlocal last
        cur = _eval_steps(doc, steps)
        if cur != last:
            last = cur
            cb(cur)

    return doc.subscribe_root(on_event)
