"""Wikipedia-dump -> plain-text filter: byte-equivalent of wikifil.pl (the
port's copy of the JAX package's data/wikifil.py, pure Python).

Behavioral equivalent of the reference's data tooling
(reference data/wikifil.pl:11-57, Matt Mahoney's filter used to produce
text8 from enwik8): keep only article text, strip XML/markup, lowercase,
spell digits as words, map everything outside [a-z] to space.

This follows wikifil.pl's rule sequence rule-for-rule: the exact regex
pipeline (thumb/left/right/px image args, link rules, digit spelling, the
[a-z]-collapse) IS the published text8 spec (Matt Mahoney, public domain),
so any byte-equivalent implementation must replicate it in order.  Perl
quirks deliberately preserved (the JAX package's tests hold its copy
byte-identical to the Perl; tests/test_torch_structured.py holds this one
equal to the JAX package's):

  * the input is consumed in records terminated by '>' (Perl ``$/ = ">"``),
    not lines — the <text>/#redirect state machine advances per record;
  * the first tag-removal substitution is NOT global: it removes one
    greedy same-line ``<...>`` span per record;
  * only &amp; &lt; &gt; are decoded; every other entity becomes a space;
  * single-brace ``{...}`` spans are removed after ``{{...}}`` templates;
  * only ASCII A-Z are lowercased (Perl ``tr/A-Z/a-z/``), and every
    non-[a-z] run collapses to one space with the record's final char
    chopped (Perl ``tr/a-z/ /cs; chop``).
"""

from __future__ import annotations

import re
import sys

_AZ = str.maketrans("ABCDEFGHIJKLMNOPQRSTUVWXYZ", "abcdefghijklmnopqrstuvwxyz")
_DIGITS = [
    ("0", " zero "), ("1", " one "), ("2", " two "), ("3", " three "),
    ("4", " four "), ("5", " five "), ("6", " six "), ("7", " seven "),
    ("8", " eight "), ("9", " nine "),
]
_SQUEEZE = re.compile(r"[^a-z]+")


def _filter_record(s: str) -> str:
    """One '>'-terminated record through the full substitution pipeline."""
    # one greedy same-line <...> removal (wikifil.pl's first, non-global sub)
    s = re.sub(r"<.*>", "", s, count=1)
    s = s.replace("&amp;", "&").replace("&lt;", "<").replace("&gt;", ">")
    s = re.sub(r"<ref[^<]*<\/ref>", "", s)          # references
    s = re.sub(r"<[^>]*>", "", s)                   # remaining xhtml tags
    s = re.sub(r"\[http:[^] ]*", "[", s)            # keep link text, drop urls
    s = re.sub(r"\|thumb", "", s, flags=re.I)
    s = re.sub(r"\|left", "", s, flags=re.I)
    s = re.sub(r"\|right", "", s, flags=re.I)
    s = re.sub(r"\|\d+px", "", s, flags=re.I)
    s = re.sub(r"\[\[image:[^\[\]]*\|", "", s, flags=re.I)
    s = re.sub(r"\[\[category:([^|\]]*)[^\]]*\]\]", r"[[\1]]", s, flags=re.I)
    s = re.sub(r"\[\[[a-z\-]*:[^\]]*\]\]", "", s)   # interwiki (case-sensitive)
    s = re.sub(r"\[\[[^\|\]]*\|", "[[", s)          # wiki url -> visible text
    s = re.sub(r"\{\{[^\}]*\}\}", "", s)            # {{templates}}
    s = re.sub(r"\{[^\}]*\}", "", s)                # {tables}
    s = s.replace("[", "").replace("]", "")
    s = re.sub(r"&[^;]*;", " ", s)                  # remaining entities
    s = " " + s + " "
    s = s.translate(_AZ)                            # tr/A-Z/a-z/ (ASCII only)
    for d, w in _DIGITS:
        s = s.replace(d, w)
    s = _SQUEEZE.sub(" ", s)                        # tr/a-z/ /cs
    return s[:-1]                                   # chop


def wikifil_text(text: str) -> str:
    """Filter wiki XML to lowercase a-z words, byte-identical to the Perl."""
    records = text.split(">")
    tail = records.pop() if records else ""
    out = []
    in_text = False
    for i, rec in enumerate(records + ([tail] if tail else [])):
        if i < len(records):
            rec = rec + ">"
        if "<text " in rec:
            in_text = True
        if re.search(r"#redirect", rec, flags=re.I):
            in_text = False
        if in_text:
            if "</text>" in rec:
                in_text = False                     # this record still prints
            out.append(_filter_record(rec))
    return "".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: python -m word2bits_tpu_torch.data.wikifil <enwik-file> "
              "[> text-out]\nEquivalent of reference data/wikifil.pl.")
        return 0
    with open(argv[0], "r", encoding="utf-8", errors="surrogateescape") as f:
        sys.stdout.write(wikifil_text(f.read()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
