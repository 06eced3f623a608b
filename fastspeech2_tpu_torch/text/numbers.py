"""Number normalization for English text, dependency-free.

Re-implements the behavior of the reference's inflect-based normalizer
(``dataset/texts/numbers.py``) without the ``inflect`` package:
currency/decimal/ordinal/year expansion with the same regex pipeline, plus a
self-contained number-to-words spellout matching inflect's output conventions
(comma-separated thousand groups, hyphenated tens, ``andword=""``).
"""

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
         "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = ["", "thousand", "million", "billion", "trillion", "quadrillion",
           "quintillion"]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    """0-99 -> words ('' for 0 when part of a larger number is handled by caller)."""
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones == 0:
        return _TENS[tens]
    return _TENS[tens] + "-" + _ONES[ones]


def _three_digits(n: int) -> str:
    """1-999 -> words (no scale suffix)."""
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + " hundred")
    if rest:
        parts.append(_two_digits(rest))
    return " ".join(parts)


def number_to_words(n: int) -> str:
    """Spell an integer the way inflect does with ``andword=''``.

    e.g. 1234567 -> 'one million, two hundred thirty-four thousand,
    five hundred sixty-seven'.
    """
    if n == 0:
        return "zero"
    if n < 0:
        return "minus " + number_to_words(-n)
    groups = []
    scale = 0
    while n > 0:
        n, g = divmod(n, 1000)
        if g:
            word = _three_digits(g)
            if scale:
                word += " " + _SCALES[scale]
            groups.append(word)
        scale += 1
    return ", ".join(reversed(groups))


def number_to_words_grouped2(n: int) -> str:
    """Year-style spellout in digit pairs, matching inflect's ``group=2, zero='oh'``
    after the reference's ``.replace(', ', ' ')`` (numbers.py:59-61).

    e.g. 1985 -> 'nineteen eighty-five'; 1905 -> 'nineteen oh five'.
    """
    s = str(n)
    if len(s) % 2 == 1:
        s = "0" + s
    words = []
    for i in range(0, len(s), 2):
        pair = int(s[i : i + 2])
        if pair == 0:
            words.append("oh oh" if s[i : i + 2] == "00" else "oh")
        elif pair < 10:
            words.append("oh " + _ONES[pair])
        else:
            words.append(_two_digits(pair))
    return " ".join(words)


def number_to_ordinal_words(n: int) -> str:
    """Spell an ordinal ('21st' -> 'twenty-first'), matching inflect's style."""
    words = number_to_words(n)
    # convert the final word to its ordinal form
    head, sep, last = words.rpartition(" ")
    prefix = head + sep
    if "-" in last:
        tens, _, ones = last.rpartition("-")
        if ones in _ORDINAL_IRREGULAR:
            return prefix + tens + "-" + _ORDINAL_IRREGULAR[ones]
        return prefix + tens + "-" + ones + "th"
    if last in _ORDINAL_IRREGULAR:
        return prefix + _ORDINAL_IRREGULAR[last]
    if last.endswith("y"):
        return prefix + last[:-1] + "ieth"
    if last.endswith("t"):  # 'eight...' handled above; 'thousandth' etc.
        return prefix + last + "h"
    return prefix + last + "th"


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"  # unexpected format
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return "%s %s, %s %s" % (dollars, dollar_unit, cents, cent_unit)
    elif dollars:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        return "%s %s" % (dollars, dollar_unit)
    elif cents:
        cent_unit = "cent" if cents == 1 else "cents"
        return "%s %s" % (cents, cent_unit)
    return "zero dollars"


def _expand_ordinal(m):
    return number_to_ordinal_words(int(m.group(0)[:-2]))


def _expand_number(m):
    """Year-aware spellout (reference numbers.py:49-63)."""
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        elif 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        elif num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        else:
            return number_to_words_grouped2(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
