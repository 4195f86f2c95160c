"""Constrained decoding: grammar-compiled logit masks.

Port of ``llm_in_practise_tpu/serve/constrain.py``, numpy only and kept
as it is, so that a mask row, a transition table and a
:class:`ConstraintError` equal the JAX package's for the same grammar and
vocabulary. ``response_format={"type": "json_schema"}`` must make every
completion parse and validate; the engine adds the masks to the logits
inside its decode bodies (:mod:`.mixed_step`), so a constrained step
stays one dispatch:

- **A small EBNF core** (:class:`Lit` / :class:`Chars` / :class:`Seq` /
  :class:`Alt` / :class:`Rep` / :class:`Ref`) interpreted as a
  character-level NFA with a pushdown continuation stack: ``Ref``
  recursion is what lets generic JSON nest, and the continuation tuples
  are the stack, so automaton states stay hashable and memoizable.
- **Two front ends**: :func:`compile_regex` (anchored subset: literals,
  classes, ``. | * + ? {m,n}``, groups) and :func:`compile_schema` (a
  JSON-Schema subset; unsupported keywords raise :class:`ConstraintError`
  and are never silently ignored, so "validates against the schema"
  holds).
- **A token-level automaton** (:class:`TokenAutomaton`): per automaton
  state, a vocab-width additive f32 logit mask (0 = allowed, ``NEG_INF``
  = forbidden) plus a token -> next-state table, compiled lazily on
  first visit by simulating each vocab piece through the char NFA. The
  lazy compile, a Python loop over the whole vocabulary per new state,
  is the dominant cost (``states_compiled``, ``compile_seconds``).
- **Per-request cursors** (:class:`ConstraintState`): the current state,
  a done flag and a violation count, carried on the engine's request,
  so a stream resumed after preemption continues from its grammar
  position without replaying it.

Generation is canonical: no inter-token whitespace, object properties
are exactly the schema's ``required`` list in declaration order, and
free-form strings draw from escape-free printable ASCII. Canonical
output is a strict subset of conforming output: everything emitted
still validates (:func:`validate_instance`).

Thread model: a compiled :class:`TokenAutomaton` is shared across
requests, and HTTP threads may compile while the engine thread reads,
so its lazy state caches are lock-guarded; cursors belong to one
request and are engine-thread-only.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np

NEG_INF = np.float32(-1e30)  # matches infer/sampling.NEG_INF

# free-form string content: printable ASCII minus the two chars that
# would need escaping ('"' and '\\') — escape-free strings keep the char
# NFA tiny and every emitted string is still valid JSON
_STR_CHARS = frozenset(chr(c) for c in range(0x20, 0x7F)) - {'"', "\\"}
_DIGITS = frozenset("0123456789")
_DIGITS19 = frozenset("123456789")


class ConstraintError(ValueError):
    """Invalid or unsupported constraint spec — the API layer maps this
    to HTTP 422 (an unsupported schema must fail fast, not generate
    output that silently ignores a keyword)."""


# --- EBNF core ------------------------------------------------------------
#
# Nodes are plain objects compared by identity; grammars are DAGs (with
# Ref-cycles for recursion) built once per compiled constraint.


class Lit:
    __slots__ = ("text",)

    def __init__(self, text: str):
        self.text = text


class Chars:
    """One character drawn from ``allowed``."""

    __slots__ = ("allowed",)

    def __init__(self, allowed):
        self.allowed = frozenset(allowed)
        if not self.allowed:
            raise ConstraintError("empty character class")


class Seq:
    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)


class Alt:
    __slots__ = ("options",)

    def __init__(self, options):
        self.options = tuple(options)
        if not self.options:
            raise ConstraintError("empty alternation")


class Rep:
    """``item (sep item)*`` with count bounds: at least ``lo`` items,
    at most ``hi`` (None = unbounded). ``lo=0`` admits the empty
    production. The separator shape is exactly JSON's comma-joined
    arrays/objects; ``sep=None`` gives plain regex repetition."""

    __slots__ = ("item", "sep", "lo", "hi")

    def __init__(self, item, sep=None, lo=0, hi=None):
        if hi is not None and hi < lo:
            raise ConstraintError(f"repetition bounds {lo}..{hi} empty")
        self.item, self.sep, self.lo, self.hi = item, sep, lo, hi


class Ref:
    """Lazy indirection — the knot that lets generic JSON values nest.
    The target is assigned after construction (two-phase tying)."""

    __slots__ = ("target",)

    def __init__(self, target=None):
        self.target = target


_END = "<end>"  # accepting marker inside a state frozenset


def _expand(node, cont, out, guard):
    """Epsilon-closure of ``node`` then ``cont`` into consuming
    positions (``("lit", node, i, cont)`` / ``("chr", node, cont)``)
    plus the ``_END`` marker. ``guard`` breaks epsilon cycles (a
    malformed grammar like ``Rep(Seq([]))``)."""
    key = (id(node), cont)
    if key in guard:
        return
    guard.add(key)
    if isinstance(node, Lit):
        if node.text:
            out.add(("lit", node, 0, cont))
        else:
            _expand_cont(cont, out, guard)
    elif isinstance(node, Chars):
        out.add(("chr", node, cont))
    elif isinstance(node, Seq):
        if not node.parts:
            _expand_cont(cont, out, guard)
            return
        c = cont
        for p in reversed(node.parts[1:]):
            c = ("n", p, c)
        _expand(node.parts[0], c, out, guard)
    elif isinstance(node, Alt):
        for opt in node.options:
            _expand(opt, cont, out, guard)
    elif isinstance(node, Rep):
        if node.lo <= 0:
            _expand_cont(cont, out, guard)
        if node.hi is None or node.hi > 0:
            _expand(node.item, ("rep", node, 1, cont), out, guard)
    elif isinstance(node, Ref):
        if node.target is None:
            raise ConstraintError("unresolved grammar reference")
        _expand(node.target, cont, out, guard)
    else:  # pragma: no cover — construction-time type error
        raise ConstraintError(f"unknown grammar node {type(node).__name__}")


def _expand_cont(cont, out, guard):
    """Continue past a finished node: pop the continuation stack."""
    if cont is None:
        out.add(_END)
        return
    tag = cont[0]
    if tag == "n":
        _expand(cont[1], cont[2], out, guard)
    elif tag == "rep":
        rep, k, rest = cont[1], cont[2], cont[3]
        if k >= rep.lo:
            _expand_cont(rest, out, guard)
        if rep.hi is None or k < rep.hi:
            if rep.sep is not None:
                _expand(rep.sep, ("repsep", rep, k, rest), out, guard)
            else:
                _expand(rep.item, ("rep", rep, k + 1, rest), out, guard)
    elif tag == "repsep":
        rep, k, rest = cont[1], cont[2], cont[3]
        _expand(rep.item, ("rep", rep, k + 1, rest), out, guard)
    else:  # pragma: no cover
        raise ConstraintError(f"unknown continuation tag {tag!r}")


def start_state(root) -> frozenset:
    out: set = set()
    _expand(root, None, out, set())
    return frozenset(out)


def char_transitions(state: frozenset) -> dict:
    """``{char: next_state}`` for every char consumable from ``state``."""
    trans: dict[str, set] = {}
    for pos in state:
        if pos == _END:
            continue
        if pos[0] == "lit":
            _, node, i, cont = pos
            tgt = trans.setdefault(node.text[i], set())
            if i + 1 < len(node.text):
                tgt.add(("lit", node, i + 1, cont))
            else:
                _expand_cont(cont, tgt, set())
        else:  # "chr"
            _, node, cont = pos
            after: set = set()
            _expand_cont(cont, after, set())
            for ch in node.allowed:
                trans.setdefault(ch, set()).update(after)
    return {ch: frozenset(s) for ch, s in trans.items()}


def is_accepting(state: frozenset) -> bool:
    return _END in state


# --- regex front-end ------------------------------------------------------

_CLASS_SHORTHAND = {
    "d": _DIGITS,
    "w": _DIGITS | frozenset("abcdefghijklmnopqrstuvwxyz"
                             "ABCDEFGHIJKLMNOPQRSTUVWXYZ_"),
    "s": frozenset(" \t"),
}


def compile_regex(pattern: str, *, charset=_STR_CHARS):
    """Anchored-full-match regex subset → grammar node. Supports
    literals, ``\\d \\w \\s`` + escaped metachars, ``.``, ``[...]``
    classes (ranges, negation), groups, ``|``, and ``* + ? {m} {m,}
    {m,n}``. Everything is intersected with ``charset`` so a schema
    string ``pattern`` can never generate JSON-breaking characters.
    Unsupported syntax raises :class:`ConstraintError`."""
    pos = 0
    n = len(pattern)

    def peek():
        return pattern[pos] if pos < n else None

    def take():
        nonlocal pos
        ch = pattern[pos]
        pos += 1
        return ch

    def parse_alt():
        opts = [parse_concat()]
        while peek() == "|":
            take()
            opts.append(parse_concat())
        return opts[0] if len(opts) == 1 else Alt(opts)

    def parse_concat():
        parts = []
        while peek() is not None and peek() not in "|)":
            parts.append(parse_repeat())
        return Seq(parts)

    def parse_repeat():
        atom = parse_atom()
        ch = peek()
        if ch == "*":
            take()
            return Rep(atom, lo=0, hi=None)
        if ch == "+":
            take()
            return Rep(atom, lo=1, hi=None)
        if ch == "?":
            take()
            return Rep(atom, lo=0, hi=1)
        if ch == "{":
            take()
            spec = ""
            while peek() is not None and peek() != "}":
                spec += take()
            if peek() != "}":
                raise ConstraintError(f"unterminated {{…}} in {pattern!r}")
            take()
            try:
                if "," in spec:
                    lo_s, hi_s = spec.split(",", 1)
                    lo = int(lo_s)
                    hi = int(hi_s) if hi_s.strip() else None
                else:
                    lo = hi = int(spec)
            except ValueError:
                raise ConstraintError(
                    f"bad repetition {{{spec}}} in {pattern!r}") from None
            return Rep(atom, lo=lo, hi=hi)
        return atom

    def class_chars(inner: str):
        chars: set = set()
        i = 0
        negate = inner.startswith("^")
        if negate:
            i = 1
        while i < len(inner):
            c = inner[i]
            if c == "\\" and i + 1 < len(inner):
                esc = inner[i + 1]
                chars |= _CLASS_SHORTHAND.get(esc, frozenset(esc))
                i += 2
                continue
            if i + 2 < len(inner) and inner[i + 1] == "-":
                chars |= {chr(x) for x in
                          range(ord(c), ord(inner[i + 2]) + 1)}
                i += 3
                continue
            chars.add(c)
            i += 1
        return (charset - chars) if negate else (chars & charset)

    def parse_atom():
        ch = take()
        if ch == "(":
            if peek() == "?":  # (?: …) non-capturing — groups don't
                take()         # capture here anyway
                if peek() != ":":
                    raise ConstraintError(
                        f"unsupported group modifier in {pattern!r}")
                take()
            inner = parse_alt()
            if peek() != ")":
                raise ConstraintError(f"unbalanced group in {pattern!r}")
            take()
            return inner
        if ch == "[":
            inner = ""
            while peek() is not None and peek() != "]":
                if peek() == "\\":
                    inner += take()
                inner += take()
            if peek() != "]":
                raise ConstraintError(f"unterminated class in {pattern!r}")
            take()
            allowed = class_chars(inner)
            if not allowed:
                raise ConstraintError(
                    f"class [{inner}] has no generatable chars")
            return Chars(allowed)
        if ch == ".":
            return Chars(charset)
        if ch == "\\":
            if peek() is None:
                raise ConstraintError(f"dangling escape in {pattern!r}")
            esc = take()
            if esc in _CLASS_SHORTHAND:
                return Chars(_CLASS_SHORTHAND[esc] & charset)
            if esc.isalnum():
                # \n, \t, \b, \1 … — either a control char no JSON
                # string can carry raw, or regex syntax this engine
                # doesn't implement. Generating the literal LETTER
                # instead would emit output that fails the very
                # pattern it must enforce — fail fast (→ 422).
                raise ConstraintError(
                    f"unsupported escape \\{esc} in {pattern!r}")
            return Lit(esc)            # escaped metachar: \. \[ \\ …
        if ch in "^$":
            # patterns are anchored by construction; an explicit anchor
            # is a no-op at its own end of the pattern and an error
            # anywhere else (a mid-pattern anchor can never match the
            # single string this grammar generates)
            if (ch == "^" and pos != 1) or (ch == "$" and pos != n):
                raise ConstraintError(
                    f"mid-pattern anchor {ch!r} in {pattern!r}")
            return Seq([])
        if ch in "*+?{":
            raise ConstraintError(f"dangling quantifier in {pattern!r}")
        return Lit(ch)

    node = parse_alt()
    if pos != n:
        raise ConstraintError(f"trailing regex syntax in {pattern!r}")
    return node


# --- JSON Schema front-end ------------------------------------------------

# Canonical generation bounds (docs/structured-output.md): unbounded
# schema productions get finite caps so constrained generation always
# TERMINATES structurally — without them a model that argmaxes digits
# (or padding chars) forever can only ever finish with a truncated,
# INVALID stream (finish_reason "length"), defeating the conformance
# guarantee. Caps only shrink the generatable set — everything emitted
# still validates. Explicit schema bounds (maxLength/maxItems) override.
_MAX_DIGITS = 16          # digits per integer part / fraction
_MAX_STRING = 256         # free-form string chars without maxLength
_FREE_STRING = 64         # string chars inside json_object mode
_MAX_ITEMS = 64           # array items without maxItems
_FREE_ITEMS = 16          # container members in json_object mode
_FREE_DEPTH = 6           # nesting depth in json_object mode

_COMMON_KEYS = {"type", "title", "description", "default", "examples",
                "$schema"}
_ALLOWED_KEYS = {
    "object": {"properties", "required", "additionalProperties"},
    "string": {"enum", "const", "minLength", "maxLength", "pattern"},
    "integer": {"enum", "const"},
    "number": {"enum", "const"},
    "boolean": {"enum", "const"},
    "null": set(),
    "array": {"items", "minItems", "maxItems"},
}


def _json_lit(value) -> Lit:
    return Lit(json.dumps(value, separators=(",", ":")))


def _integer_node():
    body = Alt([Lit("0"),
                Seq([Chars(_DIGITS19),
                     Rep(Chars(_DIGITS), hi=_MAX_DIGITS - 1)])])
    return Seq([Rep(Lit("-"), lo=0, hi=1), body])


def _number_node():
    frac = Rep(Seq([Lit("."), Rep(Chars(_DIGITS), lo=1,
                                  hi=_MAX_DIGITS)]), lo=0, hi=1)
    return Seq([_integer_node(), frac])


def _string_node(schema: dict):
    pattern = schema.get("pattern")
    if pattern is not None:
        if not isinstance(pattern, str):
            raise ConstraintError("'pattern' must be a string")
        return Seq([Lit('"'), compile_regex(pattern), Lit('"')])
    lo = int(schema.get("minLength", 0))
    hi = schema.get("maxLength")
    hi = int(hi) if hi is not None else max(_MAX_STRING, lo)
    return Seq([Lit('"'), Rep(Chars(_STR_CHARS), lo=lo, hi=hi), Lit('"')])


def _free_value_node(depth: int = _FREE_DEPTH):
    """Generic JSON value — the ``json_object`` mode grammar, built
    depth-indexed (scalars only at the bottom) so generation is
    structurally bounded: canonical caps on nesting, member count, and
    string length (docs/structured-output.md)."""
    string = Seq([Lit('"'), Rep(Chars(_STR_CHARS), hi=_FREE_STRING),
                  Lit('"')])
    scalars = [string, _number_node(), Lit("true"), Lit("false"),
               Lit("null")]
    value = Alt(scalars)
    obj = None
    for _ in range(max(1, depth)):     # ONE obj construction site
        member = Seq([string, Lit(":"), value])
        obj = Seq([Lit("{"), Rep(member, sep=Lit(","), hi=_FREE_ITEMS),
                   Lit("}")])
        arr = Seq([Lit("["), Rep(value, sep=Lit(","), hi=_FREE_ITEMS),
                   Lit("]")])
        value = Alt(scalars + [obj, arr])
    return obj  # OpenAI json_object mode: the root is an object


def compile_schema(schema) -> object:
    """JSON Schema (subset) → grammar node. Unsupported keywords raise
    :class:`ConstraintError` — silently ignoring ``minimum`` (say)
    would emit output that fails validation, the one thing this
    subsystem exists to prevent. The subset and the canonicalization
    rules are documented in docs/structured-output.md."""
    if schema is True or schema == {}:
        return _free_value_node()
    if not isinstance(schema, dict):
        raise ConstraintError(
            f"schema must be an object, got {type(schema).__name__}")
    if "anyOf" in schema:
        extra = set(schema) - _COMMON_KEYS - {"anyOf"}
        if extra:
            raise ConstraintError(
                f"keywords {sorted(extra)} unsupported next to 'anyOf'")
        opts = schema["anyOf"]
        if not isinstance(opts, list) or not opts:
            raise ConstraintError("'anyOf' must be a non-empty array")
        return Alt([compile_schema(s) for s in opts])
    if "const" in schema:
        return _json_lit(schema["const"])
    if "enum" in schema:
        vals = schema["enum"]
        if not isinstance(vals, list) or not vals:
            raise ConstraintError("'enum' must be a non-empty array")
        return Alt([_json_lit(v) for v in vals])
    t = schema.get("type")
    if isinstance(t, list):
        return Alt([compile_schema(dict(schema, type=one)) for one in t])
    if t not in _ALLOWED_KEYS:
        raise ConstraintError(
            f"unsupported schema type {t!r} (supported: "
            f"{sorted(_ALLOWED_KEYS)}, plus enum/const/anyOf)")
    extra = set(schema) - _COMMON_KEYS - _ALLOWED_KEYS[t]
    if extra:
        raise ConstraintError(
            f"unsupported keyword(s) {sorted(extra)} for type {t!r} — "
            "constrained decoding enforces the whole schema or none of "
            "it (docs/structured-output.md lists the subset)")
    if t == "string":
        return _string_node(schema)
    if t == "integer":
        return _integer_node()
    if t == "number":
        return _number_node()
    if t == "boolean":
        return Alt([Lit("true"), Lit("false")])
    if t == "null":
        return Lit("null")
    if t == "array":
        items = schema.get("items", {})
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        hi = int(hi) if hi is not None else max(_MAX_ITEMS, lo)
        item = (compile_schema(items) if items not in ({}, True)
                else _free_value_node())
        return Seq([Lit("["), Rep(item, sep=Lit(","), lo=lo, hi=hi),
                    Lit("]")])
    # object: canonical form — exactly the required properties, in
    # declaration order (a strict subset of conforming instances; see
    # module docstring)
    props = schema.get("properties", {})
    required = schema.get("required", [])
    if not isinstance(props, dict) or not isinstance(required, list):
        raise ConstraintError(
            "'properties' must be an object and 'required' an array")
    missing = [k for k in required if k not in props]
    if missing:
        raise ConstraintError(
            f"required properties {missing} have no schema in "
            "'properties'")
    ordered = [k for k in props if k in set(required)]
    parts = [Lit("{")]
    for i, key in enumerate(ordered):
        if i:
            parts.append(Lit(","))
        parts.append(Lit(json.dumps(key) + ":"))
        parts.append(compile_schema(props[key]))
    parts.append(Lit("}"))
    return Seq(parts)


def validate_instance(value, schema) -> bool:
    """Does ``value`` conform to ``schema`` (the supported subset)?
    Used by the conformance fuzz tests and the structured bench — an
    independent check of what the masks enforced, deliberately NOT
    derived from the grammar."""
    if schema is True or schema == {}:
        return True
    if "anyOf" in schema:
        return any(validate_instance(value, s) for s in schema["anyOf"])
    if "const" in schema:
        return value == schema["const"]
    if "enum" in schema:
        return value in schema["enum"]
    t = schema.get("type")
    if isinstance(t, list):
        return any(validate_instance(value, dict(schema, type=one))
                   for one in t)
    if t == "object":
        if not isinstance(value, dict):
            return False
        for key in schema.get("required", []):
            if key not in value:
                return False
        props = schema.get("properties", {})
        return all(validate_instance(v, props[k])
                   for k, v in value.items() if k in props)
    if t == "array":
        if not isinstance(value, list):
            return False
        if len(value) < int(schema.get("minItems", 0)):
            return False
        if ("maxItems" in schema
                and len(value) > int(schema["maxItems"])):
            return False
        items = schema.get("items", {})
        return all(validate_instance(v, items) for v in value)
    if t == "string":
        if not isinstance(value, str):
            return False
        if len(value) < int(schema.get("minLength", 0)):
            return False
        if ("maxLength" in schema
                and len(value) > int(schema["maxLength"])):
            return False
        if "pattern" in schema:
            import re

            return re.fullmatch(schema["pattern"], value) is not None
        return True
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if t == "number":
        return (isinstance(value, (int, float))
                and not isinstance(value, bool))
    if t == "boolean":
        return isinstance(value, bool)
    if t == "null":
        return value is None
    return False


# --- token-level automaton ------------------------------------------------


class TokenAutomaton:
    """Vocab-compiled grammar: per automaton state, an additive logit
    mask row plus a token→next-state table, built lazily on first visit
    (``ensure``). States are the char-NFA frozensets; a generation of
    L tokens visits ≤ L+1 states, so the caches grow with observed
    traffic, not with the grammar's reachable-state count.

    Shared across requests and engines — the lazy caches are guarded.
    """

    def __init__(self, root, vocab: list[str], *, eos_id: int | None,
                 kind: str = "json_schema"):
        self.root = root
        self.vocab = list(vocab)
        self.vocab_size = len(self.vocab)
        self.eos_id = eos_id
        self.kind = kind
        self.start = start_state(root)
        self._lock = threading.Lock()
        self._masks: dict = {}       # guarded-by: _lock
        self._trans: dict = {}       # guarded-by: _lock
        self._chars: dict = {}       # guarded-by: _lock
        # lifetime compile telemetry (torn float/int reads are fine for
        # monotone scrape counters — the spec_* counter convention)
        self.states_compiled = 0
        self.compile_seconds = 0.0

    # -- char-level steps (cached) --
    #
    # Read discipline: the three caches are INSERT-ONLY dicts whose
    # values are immutable once published; writers hold _lock, readers
    # use GIL-atomic lookups (a stale miss just recomputes the same
    # value). Holding the lock on the per-step mask reads would
    # serialize every engine thread against every compile.

    def _char_trans(self, state):
        # insert-only cache, GIL-atomic read; miss recomputes idempotently
        trans = self._chars.get(state)
        if trans is None:
            trans = char_transitions(state)
            with self._lock:
                self._chars[state] = trans
        return trans

    def compiled(self, state) -> bool:
        # insert-only cache, GIL-atomic membership probe
        return state in self._masks

    def ensure(self, state) -> None:
        """Compile ``state``'s mask row + token transitions (idempotent;
        the engine books cache misses as grammar compile time)."""
        # benign double-check; the publish below re-checks under _lock
        if state in self._masks:
            return
        t0 = time.monotonic()
        mask = np.full((self.vocab_size,), NEG_INF, np.float32)
        trans: dict[int, object] = {}
        for tid, piece in enumerate(self.vocab):
            if not piece:
                continue  # unmapped/empty pieces can never advance
            st = state
            ok = True
            for ch in piece:
                st = self._char_trans(st).get(ch)
                if st is None:
                    ok = False
                    break
            if ok:
                mask[tid] = 0.0
                trans[tid] = st
        if self.eos_id is not None and is_accepting(state):
            mask[self.eos_id] = 0.0
        with self._lock:
            if state not in self._masks:
                self._masks[state] = mask
                self._trans[state] = trans
                self.states_compiled += 1
                self.compile_seconds += time.monotonic() - t0

    def mask(self, state) -> np.ndarray:
        self.ensure(state)
        # published (immutable ndarray) before ensure() returns
        return self._masks[state]

    def step(self, state, token_id: int):
        """Next state after ``token_id``, or None (grammar-forbidden)."""
        self.ensure(state)
        # published (never mutated after) before ensure() returns
        return self._trans[state].get(int(token_id))

    def exhausted(self, state) -> bool:
        """No character can follow: the value is complete (the engine
        finishes the stream with ``finish_reason="stop"``)."""
        return not self._char_trans(state)

    def cursor(self) -> "ConstraintState":
        return ConstraintState(self)


class ConstraintState:
    """One request's live grammar cursor. Engine-thread-only once the
    request is slotted; it rides the Request object through
    preempt-by-recompute requeues, so a resumed stream continues from
    the exact grammar position (nothing is replayed)."""

    __slots__ = ("auto", "cur", "done", "violations")

    def __init__(self, auto: TokenAutomaton):
        self.auto = auto
        self.cur = auto.start
        self.done = False
        self.violations = 0

    @property
    def vocab_size(self) -> int:
        return self.auto.vocab_size

    def needs_compile(self) -> bool:
        return not self.auto.compiled(self.cur)

    def mask_row(self) -> np.ndarray:
        return self.auto.mask(self.cur)

    def advance(self, token_id: int) -> bool:
        """Consume one emitted token; returns True when the value is
        complete (or the token was out-of-grammar — defensively treated
        as completion so the stream ends instead of derailing; the mask
        makes this unreachable on the engine's own sampling paths)."""
        if self.done:
            return True
        nxt = self.auto.step(self.cur, token_id)
        if nxt is None:
            self.violations += 1
            self.done = True
            return True
        self.cur = nxt
        if self.auto.exhausted(nxt):
            self.done = True
        return self.done


# --- request-surface compilation -----------------------------------------


def vocab_strings(tokenizer, vocab_size: int) -> list[str]:
    """Per-id decoded pieces for the token automaton. Pieces that don't
    round-trip to clean text (byte-fragment ids in byte-level BPEs
    decode to U+FFFD) become '' — never maskable-in, which is correct:
    a grammar over characters cannot vouch for half a codepoint."""
    out = []
    for tid in range(vocab_size):
        try:
            piece = tokenizer.decode([tid])
        except Exception:  # noqa: BLE001 — unmapped id in a toy vocab
            piece = ""
        if not isinstance(piece, str) or "�" in piece:
            piece = ""
        out.append(piece)
    return out


def _tool_schema(tools, tool_choice):
    """The grammar schema for a forced tool call: the OpenAI tool-call
    value ``{"name": <fn>, "arguments": {…}}`` with arguments from the
    function's declared parameters. ``tool_choice="required"`` admits
    any declared tool (alternation)."""
    by_name = {}
    for t in tools or []:
        fn = (t or {}).get("function") or {}
        name = fn.get("name")
        if not isinstance(name, str) or not name:
            raise ConstraintError("every tool needs function.name")
        by_name[name] = fn.get("parameters") or {"type": "object"}

    def call_schema(name):
        return {"type": "object",
                "properties": {"name": {"const": name},
                               "arguments": by_name[name]},
                "required": ["name", "arguments"]}

    if isinstance(tool_choice, dict):
        name = ((tool_choice.get("function") or {}).get("name"))
        if name not in by_name:
            raise ConstraintError(
                f"tool_choice names unknown function {name!r}")
        return call_schema(name)
    if not by_name:
        raise ConstraintError("tool_choice='required' with no tools")
    if len(by_name) == 1:
        return call_schema(next(iter(by_name)))
    return {"anyOf": [call_schema(n) for n in by_name]}


def compile_request_constraint(*, response_format=None, tools=None,
                               tool_choice=None, vocab: list[str],
                               eos_id: int | None) -> TokenAutomaton | None:
    """The API-layer entry: OpenAI structured-output request fields →
    a compiled :class:`TokenAutomaton` (or None when the request is
    unconstrained). Raises :class:`ConstraintError` on invalid or
    unsupported specs (HTTP 422)."""
    kind = None
    schema = None
    if tool_choice not in (None, "auto", "none"):
        kind = "tool_call"
        schema = _tool_schema(tools, tool_choice)
    elif isinstance(response_format, dict):
        rf_type = response_format.get("type")
        if rf_type == "json_object":
            kind = "json_object"
        elif rf_type == "json_schema":
            kind = "json_schema"
            wrapper = response_format.get("json_schema")
            if not isinstance(wrapper, dict):
                raise ConstraintError(
                    "response_format.json_schema must be an object")
            schema = wrapper.get("schema")
            if not isinstance(schema, dict):
                raise ConstraintError(
                    "response_format.json_schema.schema must be an "
                    "object")
        elif rf_type not in (None, "text"):
            raise ConstraintError(
                f"unsupported response_format.type {rf_type!r}")
    if kind is None:
        return None
    root = compile_schema(schema) if schema is not None else (
        _free_value_node())
    return TokenAutomaton(root, vocab, eos_id=eos_id, kind=kind)


class ConstraintCompiler:
    """Per-server compile cache: (engine vocab, canonical spec) →
    shared :class:`TokenAutomaton`. HTTP handler threads compile
    concurrently; the cache keeps repeat structured requests (the
    agent-loop shape: same schema, every turn) at dict-lookup cost.

    LRU-BOUNDED: keys are raw client-supplied schema JSON, so an
    adversarial (or merely varied — a changing ``const`` per request)
    client would otherwise grow the cache, and every automaton's
    vocab-width mask rows, without limit. Eviction only drops the
    SHARED cache entry — automatons still referenced by in-flight
    request cursors stay alive until those requests finish."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._cache: dict = {}       # guarded-by: _lock (insertion-ordered: LRU)
        self.compiles = 0            # guarded-by: _lock
        self.compile_seconds = 0.0   # guarded-by: _lock

    def get(self, *, response_format=None, tools=None, tool_choice=None,
            vocab, vocab_key, eos_id):
        key = (vocab_key, eos_id, json.dumps(
            {"rf": response_format, "tools": tools, "tc": tool_choice},
            sort_keys=True, default=str))
        with self._lock:
            if key in self._cache:
                auto = self._cache.pop(key)   # re-insert = mark recent
                self._cache[key] = auto
                return auto
        t0 = time.monotonic()
        auto = compile_request_constraint(
            response_format=response_format, tools=tools,
            tool_choice=tool_choice, vocab=vocab, eos_id=eos_id)
        dt = time.monotonic() - t0
        with self._lock:
            self.compiles += 1
            self.compile_seconds += dt
            self._cache[key] = auto
            while len(self._cache) > self.max_entries:
                self._cache.pop(next(iter(self._cache)))
        return auto
