"""NeMo-compatible text normalization.

Semantics match the reference front-end (src/magpie.cpp:153-349): cardinal numbers
with "and" after hundreds, year-style reading for 4-digit 1000-2099, ordinal
suffixes, currency ($N -> "N dollars"), percent, minus; ASCII lowercasing is applied
by the tokenizer after normalization.
"""

from __future__ import annotations

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
    "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_ORDINAL_SPECIAL = [
    "", "first", "second", "third", "fourth", "fifth", "sixth",
    "seventh", "eighth", "ninth", "tenth", "eleventh", "twelfth",
]


def number_to_words(n: int, use_and: bool = True) -> str:
    if n < 0:
        return "minus " + number_to_words(-n, use_and)
    if n < 20:
        return _ONES[n]
    if n < 100:
        s = _TENS[n // 10]
        return s + " " + _ONES[n % 10] if n % 10 else s
    if n < 1000:
        s = _ONES[n // 100] + " hundred"
        if n % 100:
            s += " and" if use_and else ""
            s += " " + number_to_words(n % 100, use_and)
        return s
    if n >= 10**12:
        return str(n)  # beyond a trillion: leave as digits
    for scale, word in ((10**9, "billion"), (10**6, "million"), (10**3, "thousand")):
        if n >= scale:
            s = number_to_words(n // scale, use_and) + " " + word
            if n % scale:
                s += " " + number_to_words(n % scale, use_and)
            return s
    raise AssertionError("unreachable")


def year_to_words(n: int) -> str:
    """Four-digit year reading: 2024 -> "twenty twenty four", 1900 -> "nineteen hundred"."""
    if not (1000 <= n <= 9999):
        return number_to_words(n)
    high, low = divmod(n, 100)
    if low == 0:
        return number_to_words(high) + " hundred"
    if low < 10:
        return number_to_words(n)  # 2001 -> "two thousand and one" style
    return number_to_words(high) + " " + number_to_words(low)


def ordinal_to_words(n: int) -> str:
    if 1 <= n <= 12:
        return _ORDINAL_SPECIAL[n]
    cardinal = number_to_words(n)
    if 13 <= n <= 19:
        return cardinal + "th"
    if n % 10 == 0 and 20 <= n < 100:
        return cardinal[:-1] + "ieth" if cardinal.endswith("y") else cardinal + "th"
    last = n % 10
    if last in (1, 2, 3):
        head = cardinal[: cardinal.rfind(" ") + 1] if " " in cardinal else ""
        return head + ("first", "second", "third")[last - 1]
    return cardinal + "th"


def normalize_text(text: str) -> str:
    """Expand digits/currency/percent/ordinals to words. Case is preserved here."""
    out = []
    i = 0
    n = len(text)
    while i < n:
        c = text[i]

        # Currency: $123 -> "one hundred and twenty three dollars"
        if c == "$" and i + 1 < n and text[i + 1].isdigit():
            i += 1
            start = i
            while i < n and text[i].isdigit():
                i += 1
            num = int(text[start:i])
            out.append(number_to_words(num) + " dollar" + ("" if num == 1 else "s"))
            continue

        if c.isdigit() or (c == "-" and i + 1 < n and text[i + 1].isdigit()):
            negative = c == "-"
            if negative:
                i += 1
            start = i
            while i < n and text[i].isdigit():
                i += 1
            digits = text[start:i]
            num = int(digits)

            if i < n and text[i] == "%":
                i += 1
                words = number_to_words(num)
                if negative:
                    words = "minus " + words
                out.append(words + " percent")
                continue

            is_ordinal = i + 1 < n and text[i:i + 2].lower() in ("st", "nd", "rd", "th")
            if is_ordinal:
                i += 2
                words = ordinal_to_words(num)
            elif len(digits) == 4 and 1000 <= num <= 2099:
                words = year_to_words(num)
            else:
                words = number_to_words(num)
            if negative and num != 0:
                words = "minus " + words
            out.append(words)
            continue

        out.append(c)
        i += 1
    return "".join(out)
