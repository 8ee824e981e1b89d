"""Serializable token-mask specs for constrained decoding.

A ``TokenMaskSpec`` describes a language over TOKEN IDS (not bytes):
either a small regex over integer token literals, or an explicit list
of allowed token sequences.  ``compile()`` lowers the spec to a
``MaskAutomaton`` — a lazily determinized NFA whose per-state
``allowed(state, vocab)`` boolean vector is applied to the logits row
BEFORE ``sample_token``.  Because masking only subtracts probability
mass (disallowed lanes go to ``-inf``; softmax renormalizes over the
survivors) and the sampler is already deterministic per (seed,
position), a masked request emits bitwise the same tokens regardless
of what else shares its batch — the batch-composition-independence
the unconstrained path already proves carries over for free.

Regex syntax (whitespace separates atoms; token ids are decimal ints):

    7                one token
    7 9              concatenation
    7 | 9            alternation
    ( 7 9 ) *        grouping + Kleene star; ``+`` and ``?`` likewise
    .                any token in [0, vocab)
    [ 3 5 7 ]        token class
    [^ 0 1 ]         negated class (anything but 0 or 1)

The whole layer is host-side numpy over a [vocab] bool vector per
step — nothing here touches the device, so constrained requests share
the engine's step shapes with every other workload kind.
"""
from __future__ import annotations

from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TokenMaskSpec", "MaskAutomaton", "MaskError"]


class MaskError(ValueError):
    """A malformed mask spec (bad syntax, unknown kind, bad token id)."""


# -- pattern lexer/parser → Thompson NFA --------------------------------
#
# NFA edge labels: ("tok", i) | ("any",) | ("in", frozenset) |
# ("notin", frozenset); epsilon edges live in a separate list.  Each
# fragment has one start and one accept state (classic Thompson), so
# composition is pure bookkeeping.

_Label = Tuple[Any, ...]


class _Nfa:
    def __init__(self):
        self.edges: List[List[Tuple[_Label, int]]] = []
        self.eps: List[List[int]] = []

    def state(self) -> int:
        self.edges.append([])
        self.eps.append([])
        return len(self.edges) - 1

    def edge(self, src: int, label: _Label, dst: int):
        self.edges[src].append((label, dst))

    def epsilon(self, src: int, dst: int):
        self.eps[src].append(dst)


def _lex(pattern: str) -> List[str]:
    out: List[str] = []
    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c.isspace():
            i += 1
        elif c.isdigit():
            j = i
            while j < n and pattern[j].isdigit():
                j += 1
            out.append(pattern[i:j])
            i = j
        elif c in "|*+?()[].^":
            out.append(c)
            i += 1
        else:
            raise MaskError(f"mask regex: bad character {c!r} at {i}")
    return out


class _Parser:
    """Recursive descent over the lexed pattern:

        alt    := concat ('|' concat)*
        concat := repeat+
        repeat := atom ('*' | '+' | '?')*
        atom   := INT | '.' | '(' alt ')' | '[' '^'? INT+ ']'
    """

    def __init__(self, toks: List[str], nfa: _Nfa):
        self.toks = toks
        self.pos = 0
        self.nfa = nfa

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def take(self) -> str:
        t = self.peek()
        if t is None:
            raise MaskError("mask regex: unexpected end of pattern")
        self.pos += 1
        return t

    def parse(self) -> Tuple[int, int]:
        frag = self.alt()
        if self.peek() is not None:
            raise MaskError(f"mask regex: trailing {self.peek()!r}")
        return frag

    def alt(self) -> Tuple[int, int]:
        frags = [self.concat()]
        while self.peek() == "|":
            self.take()
            frags.append(self.concat())
        if len(frags) == 1:
            return frags[0]
        s, a = self.nfa.state(), self.nfa.state()
        for fs, fa in frags:
            self.nfa.epsilon(s, fs)
            self.nfa.epsilon(fa, a)
        return s, a

    def concat(self) -> Tuple[int, int]:
        frags = []
        while self.peek() is not None and self.peek() not in ")|":
            frags.append(self.repeat())
        if not frags:
            raise MaskError("mask regex: empty alternative")
        s, a = frags[0]
        for fs, fa in frags[1:]:
            self.nfa.epsilon(a, fs)
            a = fa
        return s, a

    def repeat(self) -> Tuple[int, int]:
        s, a = self.atom()
        while self.peek() in ("*", "+", "?"):
            op = self.take()
            ns, na = self.nfa.state(), self.nfa.state()
            self.nfa.epsilon(ns, s)
            self.nfa.epsilon(a, na)
            if op in ("*", "?"):
                self.nfa.epsilon(ns, na)
            if op in ("*", "+"):
                self.nfa.epsilon(a, s)
            s, a = ns, na
        return s, a

    def atom(self) -> Tuple[int, int]:
        t = self.take()
        if t == "(":
            frag = self.alt()
            if self.take() != ")":
                raise MaskError("mask regex: unbalanced '('")
            return frag
        s, a = self.nfa.state(), self.nfa.state()
        if t == ".":
            self.nfa.edge(s, ("any",), a)
        elif t == "[":
            neg = False
            if self.peek() == "^":
                self.take()
                neg = True
            ids = []
            while self.peek() is not None and self.peek() != "]":
                tok = self.take()
                if not tok.isdigit():
                    raise MaskError(f"mask regex: bad class member "
                                    f"{tok!r}")
                ids.append(int(tok))
            if self.take() != "]":  # consumed the "]" or raised
                raise MaskError("mask regex: unbalanced '['")
            if not ids:
                raise MaskError("mask regex: empty token class")
            fs = frozenset(ids)
            self.nfa.edge(s, ("notin", fs) if neg else ("in", fs), a)
        elif t.isdigit():
            self.nfa.edge(s, ("tok", int(t)), a)
        else:
            raise MaskError(f"mask regex: unexpected {t!r}")
        return s, a


class MaskAutomaton:
    """Lazily determinized token automaton.

    States are integers minted on first visit (state 0 is the start);
    ``allowed(state, vocab)`` yields the [vocab] bool vector of legal
    next tokens (cached per (state, vocab)), ``step(state, token)``
    advances (None = no transition), ``accepting(state)`` says whether
    the consumed prefix is a complete sentence of the language.
    Instances are immutable after construction apart from the memo
    dicts, and every mutation happens under the caller's single engine
    lock, so no locking of its own is needed.
    """

    def __init__(self, nfa: _Nfa, start: int, accept: int):
        self._nfa = nfa
        self._accept = accept
        self._sets: List[FrozenSet[int]] = []
        self._ids: Dict[FrozenSet[int], int] = {}
        self._allowed: Dict[Tuple[int, int], np.ndarray] = {}
        self._trans: Dict[Tuple[int, int], Optional[int]] = {}
        self.start = self._intern(self._closure({start}))

    # -- NFA plumbing ---------------------------------------------------
    def _closure(self, states) -> FrozenSet[int]:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for d in self._nfa.eps[s]:
                if d not in seen:
                    seen.add(d)
                    stack.append(d)
        return frozenset(seen)

    def _intern(self, sset: FrozenSet[int]) -> int:
        sid = self._ids.get(sset)
        if sid is None:
            sid = len(self._sets)
            self._ids[sset] = sid
            self._sets.append(sset)
        return sid

    @staticmethod
    def _matches(label: _Label, token: int) -> bool:
        kind = label[0]
        if kind == "tok":
            return token == label[1]
        if kind == "any":
            return True
        if kind == "in":
            return token in label[1]
        return token not in label[1]  # "notin"

    # -- public surface -------------------------------------------------
    def allowed(self, state: int, vocab: int) -> np.ndarray:
        key = (state, vocab)
        vec = self._allowed.get(key)
        if vec is None:
            vec = np.zeros(vocab, dtype=bool)
            for s in self._sets[state]:
                for label, _dst in self._nfa.edges[s]:
                    kind = label[0]
                    if kind == "tok":
                        if 0 <= label[1] < vocab:
                            vec[label[1]] = True
                    elif kind == "any":
                        vec[:] = True
                    elif kind == "in":
                        for t in label[1]:
                            if 0 <= t < vocab:
                                vec[t] = True
                    else:  # notin
                        neg = np.ones(vocab, dtype=bool)
                        for t in label[1]:
                            if 0 <= t < vocab:
                                neg[t] = False
                        vec |= neg
            vec.setflags(write=False)
            self._allowed[key] = vec
        return vec

    def step(self, state: int, token: int) -> Optional[int]:
        key = (state, int(token))
        if key in self._trans:
            return self._trans[key]
        move = set()
        for s in self._sets[state]:
            for label, dst in self._nfa.edges[s]:
                if self._matches(label, int(token)):
                    move.add(dst)
        nxt = self._intern(self._closure(move)) if move else None
        self._trans[key] = nxt
        return nxt

    def accepting(self, state: int) -> bool:
        return self._accept in self._sets[state]

    def max_token(self) -> int:
        """Largest token id named anywhere in the automaton (-1 if only
        wildcards/negations appear) — submit-time vocab validation."""
        hi = -1
        for edges in self._nfa.edges:
            for label, _dst in edges:
                kind = label[0]
                if kind == "tok":
                    hi = max(hi, label[1])
                elif kind in ("in", "notin"):
                    hi = max(hi, max(label[1]))
        return hi


class TokenMaskSpec:
    """Wire-serializable constraint: ``kind`` is ``"regex"`` (pattern
    over token ids, syntax in the module docstring) or ``"choices"``
    (explicit list of allowed token sequences)."""

    def __init__(self, kind: str, pattern: Optional[str] = None,
                 choices: Optional[Sequence[Sequence[int]]] = None):
        if kind == "regex":
            if not isinstance(pattern, str) or not pattern.strip():
                raise MaskError("regex mask needs a non-empty pattern")
            self.pattern: Optional[str] = pattern
            self.choices: Optional[List[List[int]]] = None
        elif kind == "choices":
            if not choices:
                raise MaskError("choices mask needs >= 1 sequence")
            seqs = []
            for seq in choices:
                seq = [int(t) for t in seq]
                if not seq or any(t < 0 for t in seq):
                    raise MaskError("choices must be non-empty lists "
                                    "of token ids >= 0")
                seqs.append(seq)
            self.pattern = None
            self.choices = seqs
        else:
            raise MaskError(f"unknown mask kind {kind!r}")
        self.kind = kind
        self._automaton: Optional[MaskAutomaton] = None

    @classmethod
    def regex(cls, pattern: str) -> "TokenMaskSpec":
        return cls("regex", pattern=pattern)

    @classmethod
    def one_of(cls, choices: Sequence[Sequence[int]]) -> "TokenMaskSpec":
        return cls("choices", choices=choices)

    def to_dict(self) -> Dict[str, Any]:
        if self.kind == "regex":
            return {"kind": "regex", "pattern": self.pattern}
        return {"kind": "choices", "choices": self.choices}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TokenMaskSpec":
        if not isinstance(d, dict):
            raise MaskError(f"mask spec must be a dict, got "
                            f"{type(d).__name__}")
        known = {"kind", "pattern", "choices"}
        extra = set(d) - known
        if extra:
            raise MaskError(f"mask spec has unknown keys {sorted(extra)}")
        return cls(d.get("kind", ""), pattern=d.get("pattern"),
                   choices=d.get("choices"))

    def compile(self) -> MaskAutomaton:
        if self._automaton is None:
            nfa = _Nfa()
            if self.kind == "regex":
                start, accept = _Parser(_lex(self.pattern or ""),
                                        nfa).parse()
            else:
                start, accept = nfa.state(), nfa.state()
                for seq in self.choices or []:
                    prev = start
                    for tok in seq:
                        nxt = nfa.state()
                        nfa.edge(prev, ("tok", tok), nxt)
                        prev = nxt
                    nfa.epsilon(prev, accept)
            self._automaton = MaskAutomaton(nfa, start, accept)
        return self._automaton
