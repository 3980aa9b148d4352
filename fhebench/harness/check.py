"""Whether the timed path's answers are right: each kept request's outputs,
decrypted by the program's own decryption, against the plain reference's
answer to the same plaintext inputs, slot by slot. BFV computes exactly
over Z_t: a slot is wrong where it differs modulo the plaintext modulus t.
CKKS computes approximately: a slot is wrong where it lies further than
the configuration's `tolerance` from the reference. The numbers compared,
each with its limit:

  wrong_slots   output slots that differ from the reference   at most 0
  unanswered    kept requests whose answer never came           at most 0
  checked_slots output slots compared                           at least 1

CKKS's widest gap of a slot from the reference, max_abs_error, is a
reading beside them, with no limit of its own: a slot past the tolerance
is already a wrong slot.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

LIMITS = {"wrong_slots": ("at most", 0), "unanswered": ("at most", 0),
          "checked_slots": ("at least", 1)}


def judge(answers: Dict[int, Dict[str, List[List[int]]]],
          queries: Dict[int, Dict[str, List[List[int]]]],
          expected: Callable, lengths: Dict[str, int], t: int,
          tolerance: Optional[float] = None) -> Dict:
    """answers: {request: {output: [rows of decrypted slots]}} (None for an
    answer that never came); queries: {request: {input: [rows of values]}}
    of the same requests; expected(query) -> [one {output: [slots]} a
    row], the reference (or the control in its place). With a tolerance
    (CKKS), slots are compared by their distance and the widest is read
    as max_abs_error."""
    wrong = checked = unanswered = 0
    widest = 0.0
    for req, query in queries.items():
        got = answers.get(req)
        if got is None:
            unanswered += 1
            continue
        for r, want in enumerate(expected(query)):
            for name, length in lengths.items():
                have = got[name][r][:length]
                exp = want[name][:length]
                checked += length
                if tolerance is None:
                    wrong += sum(1 for a, b in zip(have, exp) if (a - b) % t)
                else:
                    gaps = [abs(a - b) for a, b in zip(have, exp)]
                    # a gap that is not a number is wrong
                    wrong += sum(1 for g in gaps if not g <= tolerance)
                    widest = max([widest] + [g for g in gaps if g == g])
                wrong += length - min(len(have), len(exp))
    readings = {"wrong_slots": wrong, "unanswered": unanswered,
                "checked_slots": checked}
    if tolerance is not None:
        readings["max_abs_error"] = widest
    return readings


def verdict(readings: Dict[str, int]) -> Dict[str, Dict]:
    """{name: {"value", "limit", "kind"}} in LIMITS' order, and whether all
    hold, as (table, correct)."""
    table, ok = {}, True
    for name, (kind, limit) in LIMITS.items():
        value = readings[name]
        table[name] = {"value": value, "limit": limit, "kind": kind}
        ok &= value <= limit if kind == "at most" else value >= limit
    return table, ok


def lines(table: Dict[str, Dict]) -> List[str]:
    """One line a number compared: `check <name> <value> limit <kind>
    <limit>`."""
    return [f"check {name} {rec['value']} limit {rec['kind']} "
            f"{rec['limit']}" for name, rec in table.items()]
