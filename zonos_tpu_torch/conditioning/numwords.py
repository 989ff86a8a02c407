"""Native number-words for the text frontend (host-side).

The reference rewrites every digit sequence to ENGLISH words before
phonemization regardless of request language (conditioning.py:139-221 via
``inflect``), so a French request hears "vingt-cinq" as "twenty-five" read
with French letter rules. This module spells integers and decimals in the
request language instead; ``clean`` (conditioning/text.py) consults it and
falls back to the English path for unsupported codes. Chinese/Japanese have
their own native readers (conditioning/{zh,yue,ja}.py) and never reach here.

Scope: cardinals 0 .. 999,999,999,999 plus decimals ("," or "." read as the
language's separator word, fractional digits read one by one). Ordinal and
currency morphology is out of scope — grammatical case/gender agreement is
simplified to the citation forms, which is the intelligibility floor TTS
needs (and far above English words in a foreign accent).
"""

from __future__ import annotations

import re

# ---------------------------------------------------------------------------
# Per-language cardinal spellers. Each takes a non-negative int < 10^12.
# ---------------------------------------------------------------------------


def _es(n: int) -> str:
    units = ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis",
             "siete", "ocho", "nueve", "diez", "once", "doce", "trece",
             "catorce", "quince", "dieciséis", "diecisiete", "dieciocho",
             "diecinueve", "veinte", "veintiuno", "veintidós", "veintitrés",
             "veinticuatro", "veinticinco", "veintiséis", "veintisiete",
             "veintiocho", "veintinueve"]
    tens = ["", "", "", "treinta", "cuarenta", "cincuenta", "sesenta",
            "setenta", "ochenta", "noventa"]
    hundreds = ["", "ciento", "doscientos", "trescientos", "cuatrocientos",
                "quinientos", "seiscientos", "setecientos", "ochocientos",
                "novecientos"]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append("cien" if (h == 1 and r == 0) else hundreds[h])
        if r:
            if r < 30:
                parts.append(units[r])
            else:
                t, u = divmod(r, 10)
                parts.append(tens[t] + (" y " + units[u] if u else ""))
        return " ".join(parts) if parts else ""

    def apocopate(w: str) -> str:
        # uno/veintiuno → un/veintiún before a masculine noun (mil, millones)
        if w.endswith("veintiuno"):
            return w[:-9] + "veintiún"
        if w.endswith("uno"):
            return w[:-3] + "un"
        return w

    if n == 0:
        return "cero"
    parts = []
    mill, rest = divmod(n, 10**6)
    if mill:
        if mill == 1:
            parts.append("un millón")
        else:
            parts.append(apocopate(_es(mill)) + " millones")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append("mil" if th == 1 else apocopate(below1000(th)) + " mil")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _fr(n: int) -> str:
    units = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept",
             "huit", "neuf", "dix", "onze", "douze", "treize", "quatorze",
             "quinze", "seize", "dix-sept", "dix-huit", "dix-neuf"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        if t in (2, 3, 4, 5, 6):
            name = ["", "", "vingt", "trente", "quarante", "cinquante",
                    "soixante"][t]
            if u == 1:
                return name + " et un"
            return name + ("-" + units[u] if u else "")
        if t == 7:
            if u == 1:
                return "soixante et onze"
            return "soixante-" + units[10 + u]
        if t == 8:
            return "quatre-vingts" if u == 0 else "quatre-vingt-" + units[u]
        return "quatre-vingt-" + units[10 + u]  # 90-99

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        if not h:
            return below100(r)
        if h == 1:
            head = "cent"
        else:
            head = units[h] + (" cents" if r == 0 else " cent")
        return head + (" " + below100(r) if r else "")

    def de_s(w: str) -> str:
        # quatre-vingts / deux cents drop the -s before a following numeral.
        if w.endswith("vingts") or w.endswith("cents"):
            return w[:-1]
        return w

    if n == 0:
        return "zéro"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append("un milliard" if bill == 1 else de_s(_fr(bill)) + " milliards")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("un million" if mill == 1 else de_s(_fr(mill)) + " millions"))
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append("mille" if th == 1 else de_s(below1000(th)) + " mille")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _de(n: int) -> str:
    units = ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs",
             "sieben", "acht", "neun", "zehn", "elf", "zwölf", "dreizehn",
             "vierzehn", "fünfzehn", "sechzehn", "siebzehn", "achtzehn",
             "neunzehn"]
    tens = ["", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig",
            "siebzig", "achtzig", "neunzig"]

    def unit_c(u: int) -> str:  # "ein" in compounds, "eins" standalone
        return "ein" if u == 1 else units[u]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]  # final 1 is always "eins"
        t, u = divmod(k, 10)
        if u:
            return unit_c(u) + "und" + tens[t]
        return tens[t]

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        out = ""
        if h:
            out += unit_c(h) + "hundert"
        if r:
            out += below100(r)
        return out

    if n == 0:
        return "null"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append("eine Milliarde" if bill == 1 else _de(bill) + " Milliarden")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append("eine Million" if mill == 1 else _de(mill) + " Millionen")
    th, rest2 = divmod(rest, 1000)
    tail = ""
    if th:
        tail = below1000(th) + "tausend"
        if th == 1:
            tail = "eintausend"
    if rest2:
        tail += below1000(rest2)  # zweitausendeins: one word
    if tail:
        parts.append(tail)
    return " ".join(parts)


def _it(n: int) -> str:
    units = ["zero", "uno", "due", "tre", "quattro", "cinque", "sei",
             "sette", "otto", "nove", "dieci", "undici", "dodici", "tredici",
             "quattordici", "quindici", "sedici", "diciassette", "diciotto",
             "diciannove"]
    tens = ["", "", "venti", "trenta", "quaranta", "cinquanta", "sessanta",
            "settanta", "ottanta", "novanta"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        base = tens[t]
        if u in (1, 8):  # vowel elision: ventuno, ventotto
            base = base[:-1]
        return base + (units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        out = ""
        if h:
            out += ("" if h == 1 else units[h]) + "cento"
        out += below100(r) if r else ""
        return out

    if n == 0:
        return "zero"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append("un miliardo" if bill == 1 else _it(bill) + " miliardi")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append("un milione" if mill == 1 else _it(mill) + " milioni")
    th, rest2 = divmod(rest, 1000)
    tail = ""
    if th:
        tail = "mille" if th == 1 else below1000(th) + "mila"
    tail += below1000(rest2) if rest2 else ""  # millenovecento...: one word
    if tail:
        parts.append(tail)
    return " ".join(parts)


def _pt(n: int) -> str:
    units = ["zero", "um", "dois", "três", "quatro", "cinco", "seis", "sete",
             "oito", "nove", "dez", "onze", "doze", "treze", "catorze",
             "quinze", "dezesseis", "dezessete", "dezoito", "dezenove"]
    tens = ["", "", "vinte", "trinta", "quarenta", "cinquenta", "sessenta",
            "setenta", "oitenta", "noventa"]
    hundreds = ["", "cento", "duzentos", "trezentos", "quatrocentos",
                "quinhentos", "seiscentos", "setecentos", "oitocentos",
                "novecentos"]

    def below1000(k: int) -> str:
        if k == 100:
            return "cem"
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append(hundreds[h])
        if r:
            if r < 20:
                parts.append(units[r])
            else:
                t, u = divmod(r, 10)
                parts.append(tens[t] + (" e " + units[u] if u else ""))
        return " e ".join(parts)

    if n == 0:
        return "zero"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append("um bilhão" if bill == 1 else _pt(bill) + " bilhões")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append("um milhão" if mill == 1 else _pt(mill) + " milhões")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append("mil" if th == 1 else below1000(th) + " mil")
    if rest2:
        joiner = " e " if rest2 < 100 or rest2 % 100 == 0 else " "
        if parts:
            return " ".join(parts[:-1]) + ("" if len(parts) < 2 else " ") + parts[-1] + joiner + below1000(rest2)
        parts.append(below1000(rest2))
    return " ".join(parts)


def _slavic(n, units, teens, tens, hundreds, thousand_forms, million_forms,
            one_thousand=None, two=None, billion_forms=None):
    """Shared East-Slavic/Polish/Czech shape: thousand/million agree with
    the count (1 / 2-4 / 5+)."""
    def agree(k, forms):
        if k % 100 in (11, 12, 13, 14):
            return forms[2]
        if k % 10 == 1:
            return forms[0]
        if k % 10 in (2, 3, 4):
            return forms[1]
        return forms[2]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append(hundreds[h])
        if r:
            if 10 <= r <= 19:
                parts.append(teens[r - 10])
            else:
                t, u = divmod(r, 10)
                if t:
                    parts.append(tens[t])
                if u:
                    parts.append(units[u])
        return " ".join(parts)

    if n == 0:
        return units[0]
    parts = []
    bill, rest0 = divmod(n, 10**9)
    if bill and billion_forms:
        head = below1000(bill) if bill > 1 else ""
        parts.append((head + " " if head else "") + agree(bill, billion_forms))
        n = rest0
    mill, rest = divmod(n, 10**6)
    if mill:
        head = below1000(mill) if mill > 1 else ""
        parts.append((head + " " if head else "") + agree(mill, million_forms))
    th, rest2 = divmod(rest, 1000)
    if th:
        if th == 1:
            head = one_thousand or ""
        elif th % 10 in (1, 2) and th % 100 not in (11, 12) and two:
            t10, u = divmod(th, 10)
            head = (below1000(t10 * 10) + " " if t10 else "") + (
                two[u - 1])  # feminine одна/две
        else:
            head = below1000(th)
        parts.append(((head + " ") if head else "") + agree(th, thousand_forms))
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(p for p in parts if p)


def _ru(n: int) -> str:
    return _slavic(
        n,
        ["ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь",
         "восемь", "девять"],
        ["десять", "одиннадцать", "двенадцать", "тринадцать",
         "четырнадцать", "пятнадцать", "шестнадцать", "семнадцать",
         "восемнадцать", "девятнадцать"],
        ["", "десять", "двадцать", "тридцать", "сорок", "пятьдесят",
         "шестьдесят", "семьдесят", "восемьдесят", "девяносто"],
        ["", "сто", "двести", "триста", "четыреста", "пятьсот", "шестьсот",
         "семьсот", "восемьсот", "девятьсот"],
        ("тысяча", "тысячи", "тысяч"),
        ("миллион", "миллиона", "миллионов"),
        one_thousand="одна",
        two=("одна", "две"),
        billion_forms=("миллиард", "миллиарда", "миллиардов"),
    )


def _uk(n: int) -> str:
    return _slavic(
        n,
        ["нуль", "один", "два", "три", "чотири", "п'ять", "шість", "сім",
         "вісім", "дев'ять"],
        ["десять", "одинадцять", "дванадцять", "тринадцять",
         "чотирнадцять", "п'ятнадцять", "шістнадцять", "сімнадцять",
         "вісімнадцять", "дев'ятнадцять"],
        ["", "десять", "двадцять", "тридцять", "сорок", "п'ятдесят",
         "шістдесят", "сімдесят", "вісімдесят", "дев'яносто"],
        ["", "сто", "двісті", "триста", "чотириста", "п'ятсот", "шістсот",
         "сімсот", "вісімсот", "дев'ятсот"],
        ("тисяча", "тисячі", "тисяч"),
        ("мільйон", "мільйони", "мільйонів"),
        one_thousand="одна",
        two=("одна", "дві"),
        billion_forms=("мільярд", "мільярди", "мільярдів"),
    )


def _pl(n: int) -> str:
    return _slavic(
        n,
        ["zero", "jeden", "dwa", "trzy", "cztery", "pięć", "sześć",
         "siedem", "osiem", "dziewięć"],
        ["dziesięć", "jedenaście", "dwanaście", "trzynaście", "czternaście",
         "piętnaście", "szesnaście", "siedemnaście", "osiemnaście",
         "dziewiętnaście"],
        ["", "dziesięć", "dwadzieścia", "trzydzieści", "czterdzieści",
         "pięćdziesiąt", "sześćdziesiąt", "siedemdziesiąt",
         "osiemdziesiąt", "dziewięćdziesiąt"],
        ["", "sto", "dwieście", "trzysta", "czterysta", "pięćset",
         "sześćset", "siedemset", "osiemset", "dziewięćset"],
        ("tysiąc", "tysiące", "tysięcy"),
        ("milion", "miliony", "milionów"),
        billion_forms=("miliard", "miliardy", "miliardów"),
    )


def _cs(n: int) -> str:
    return _slavic(
        n,
        ["nula", "jedna", "dva", "tři", "čtyři", "pět", "šest", "sedm",
         "osm", "devět"],
        ["deset", "jedenáct", "dvanáct", "třináct", "čtrnáct", "patnáct",
         "šestnáct", "sedmnáct", "osmnáct", "devatenáct"],
        ["", "deset", "dvacet", "třicet", "čtyřicet", "padesát", "šedesát",
         "sedmdesát", "osmdesát", "devadesát"],
        ["", "sto", "dvě stě", "tři sta", "čtyři sta", "pět set",
         "šest set", "sedm set", "osm set", "devět set"],
        ("tisíc", "tisíce", "tisíc"),
        ("milion", "miliony", "milionů"),
        billion_forms=("miliarda", "miliardy", "miliard"),
    )


def _nl(n: int) -> str:
    units = ["nul", "een", "twee", "drie", "vier", "vijf", "zes", "zeven",
             "acht", "negen", "tien", "elf", "twaalf", "dertien",
             "veertien", "vijftien", "zestien", "zeventien", "achttien",
             "negentien"]
    tens = ["", "", "twintig", "dertig", "veertig", "vijftig", "zestig",
            "zeventig", "tachtig", "negentig"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        if not u:
            return tens[t]
        joiner = "ën" if units[u][-1] == "e" else "en"  # tweeëntwintig
        return units[u] + joiner + tens[t]

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        out = ""
        if h:
            out += ("" if h == 1 else units[h]) + "honderd"
        if r:
            out += below100(r)
        return out

    if n == 0:
        return "nul"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("een" if bill == 1 else _nl(bill)) + " miljard")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append("een miljoen" if mill == 1 else _nl(mill) + " miljoen")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th)) + "duizend")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _tr(n: int) -> str:
    units = ["sıfır", "bir", "iki", "üç", "dört", "beş", "altı", "yedi",
             "sekiz", "dokuz"]
    tens = ["", "on", "yirmi", "otuz", "kırk", "elli", "altmış", "yetmiş",
            "seksen", "doksan"]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append(("" if h == 1 else units[h] + " ") + "yüz")
        t, u = divmod(r, 10)
        if t:
            parts.append(tens[t])
        if u:
            parts.append(units[u])
        return " ".join(parts)

    if n == 0:
        return "sıfır"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("bir" if bill == 1 else _tr(bill)) + " milyar")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("bir" if mill == 1 else _tr(mill)) + " milyon")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "bin")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _sv(n: int) -> str:
    units = ["noll", "ett", "två", "tre", "fyra", "fem", "sex", "sju",
             "åtta", "nio", "tio", "elva", "tolv", "tretton", "fjorton",
             "femton", "sexton", "sjutton", "arton", "nitton"]
    tens = ["", "", "tjugo", "trettio", "fyrtio", "femtio", "sextio",
            "sjuttio", "åttio", "nittio"]

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        out = ""
        if h:
            out += ("" if h == 1 else units[h]) + "hundra"
        if r:
            if r < 20:
                out += units[r]
            else:
                t, u = divmod(r, 10)
                out += tens[t] + (units[u] if u else "")
        return out

    if n == 0:
        return "noll"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("en" if bill == 1 else _sv(bill)) + " miljard" +
                     ("er" if bill > 1 else ""))
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("en" if mill == 1 else _sv(mill)) + " miljon" +
                     ("er" if mill > 1 else ""))
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th)) + "tusen")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _da(n: int) -> str:
    units = ["nul", "en", "to", "tre", "fire", "fem", "seks", "syv", "otte",
             "ni", "ti", "elleve", "tolv", "tretten", "fjorten", "femten",
             "seksten", "sytten", "atten", "nitten"]
    tens = ["", "", "tyve", "tredive", "fyrre", "halvtreds", "tres",
            "halvfjerds", "firs", "halvfems"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        if not u:
            return tens[t]
        return units[u] + "og" + tens[t]  # femogtyve

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        out = ""
        if h:
            out += ("et" if h == 1 else units[h]) + " hundrede"
        if r:
            out += (" og " if h else "") + below100(r)
        return out

    if n == 0:
        return "nul"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("en" if bill == 1 else _da(bill)) + " milliard" +
                     ("er" if bill > 1 else ""))
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("en" if mill == 1 else _da(mill)) + " million" +
                     ("er" if mill > 1 else ""))
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("et" if th == 1 else below1000(th)) + " tusind")
    if rest2:
        parts.append(below1000(rest2))
    return " og ".join(parts) if len(parts) > 1 and rest2 and rest2 < 100 else " ".join(parts)


def _no(n: int) -> str:
    units = ["null", "en", "to", "tre", "fire", "fem", "seks", "sju",
             "åtte", "ni", "ti", "elleve", "tolv", "tretten", "fjorten",
             "femten", "seksten", "sytten", "atten", "nitten"]
    tens = ["", "", "tjue", "tretti", "førti", "femti", "seksti", "sytti",
            "åtti", "nitti"]

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        out = ""
        if h:
            out += ("" if h == 1 else units[h]) + "hundre"
        if r:
            if r < 20:
                out += units[r]
            else:
                t, u = divmod(r, 10)
                out += tens[t] + (units[u] if u else "")
        return out

    if n == 0:
        return "null"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("en" if bill == 1 else _no(bill)) + " milliard" +
                     ("er" if bill > 1 else ""))
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("en" if mill == 1 else _no(mill)) + " million" +
                     ("er" if mill > 1 else ""))
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("ett" if th == 1 else below1000(th)) + " tusen")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _ar(n: int) -> str:
    """MSA cardinals, units-before-tens with و (khamsa wa-ʿishrūn)."""
    units = ["صفر", "واحد", "اثنان", "ثلاثة", "أربعة", "خمسة", "ستة",
             "سبعة", "ثمانية", "تسعة", "عشرة", "أحد عشر", "اثنا عشر",
             "ثلاثة عشر", "أربعة عشر", "خمسة عشر", "ستة عشر", "سبعة عشر",
             "ثمانية عشر", "تسعة عشر"]
    tens = ["", "", "عشرون", "ثلاثون", "أربعون", "خمسون", "ستون",
            "سبعون", "ثمانون", "تسعون"]
    hundreds = ["", "مئة", "مئتان", "ثلاثمئة", "أربعمئة", "خمسمئة",
                "ستمئة", "سبعمئة", "ثمانمئة", "تسعمئة"]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append(hundreds[h])
        if r:
            if r < 20:
                parts.append(units[r])
            else:
                t, u = divmod(r, 10)
                if u:
                    parts.append(units[u] + " و" + tens[t])
                else:
                    parts.append(tens[t])
        return " و".join(parts)

    if n == 0:
        return "صفر"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append("مليار" if bill == 1 else below1000(bill) + " مليار")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append("مليون" if mill == 1 else below1000(mill) + " مليون")
    th, rest2 = divmod(rest, 1000)
    if th:
        if th == 1:
            parts.append("ألف")
        elif th == 2:
            parts.append("ألفان")
        elif th <= 10:
            parts.append(units[th] + " آلاف")
        else:
            parts.append(below1000(th) + " ألف")
    if rest2:
        parts.append(below1000(rest2))
    return " و".join(parts)


def _fa(n: int) -> str:
    units = ["صفر", "یک", "دو", "سه", "چهار", "پنج", "شش", "هفت", "هشت",
             "نه", "ده", "یازده", "دوازده", "سیزده", "چهارده", "پانزده",
             "شانزده", "هفده", "هجده", "نوزده"]
    tens = ["", "", "بیست", "سی", "چهل", "پنجاه", "شصت", "هفتاد", "هشتاد",
            "نود"]
    hundreds = ["", "صد", "دویست", "سیصد", "چهارصد", "پانصد", "ششصد",
                "هفتصد", "هشتصد", "نهصد"]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append(hundreds[h])
        if r:
            if r < 20:
                parts.append(units[r])
            else:
                t, u = divmod(r, 10)
                parts.append(tens[t] + (" و " + units[u] if u else ""))
        return " و ".join(parts)

    if n == 0:
        return "صفر"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("یک" if bill == 1 else below1000(bill)) + " میلیارد")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("یک" if mill == 1 else below1000(mill)) + " میلیون")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "هزار")
    if rest2:
        parts.append(below1000(rest2))
    return " و ".join(parts)


def _el(n: int) -> str:
    units = ["μηδέν", "ένα", "δύο", "τρία", "τέσσερα", "πέντε", "έξι",
             "επτά", "οκτώ", "εννέα", "δέκα", "έντεκα", "δώδεκα"]
    teens = ["δεκατρία", "δεκατέσσερα", "δεκαπέντε", "δεκαέξι",
             "δεκαεπτά", "δεκαοκτώ", "δεκαεννέα"]
    tens = ["", "", "είκοσι", "τριάντα", "σαράντα", "πενήντα", "εξήντα",
            "εβδομήντα", "ογδόντα", "ενενήντα"]
    hundreds = ["", "εκατόν", "διακόσια", "τριακόσια", "τετρακόσια",
                "πεντακόσια", "εξακόσια", "επτακόσια", "οκτακόσια",
                "εννιακόσια"]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append("εκατό" if (h == 1 and r == 0) else hundreds[h])
        if r:
            if r < 13:
                parts.append(units[r])
            elif r < 20:
                parts.append(teens[r - 13])
            else:
                t, u = divmod(r, 10)
                parts.append(tens[t] + (" " + units[u] if u else ""))
        return " ".join(parts)

    if n == 0:
        return "μηδέν"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append("ένα δισεκατομμύριο" if bill == 1
                     else below1000(bill) + " δισεκατομμύρια")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append("ένα εκατομμύριο" if mill == 1
                     else below1000(mill) + " εκατομμύρια")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append("χίλια" if th == 1 else below1000(th) + " χιλιάδες")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _fi(n: int) -> str:
    units = ["nolla", "yksi", "kaksi", "kolme", "neljä", "viisi", "kuusi",
             "seitsemän", "kahdeksan", "yhdeksän", "kymmenen"]

    def below100(k: int) -> str:
        if k <= 10:
            return units[k]
        if k < 20:
            return units[k - 10] + "toista"
        t, u = divmod(k, 10)
        return units[t] + "kymmentä" + (units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        out = ""
        if h:
            out += ("" if h == 1 else units[h]) + "sata" + ("a" if h > 1 else "")
        if r:
            out += below100(r)
        return out

    if n == 0:
        return "nolla"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append("miljardi" if bill == 1 else below1000(bill) + " miljardia")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append("miljoona" if mill == 1 else below1000(mill) + " miljoonaa")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append("tuhat" if th == 1 else below1000(th) + "tuhatta")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _hu(n: int) -> str:
    units = ["nulla", "egy", "kettő", "három", "négy", "öt", "hat", "hét",
             "nyolc", "kilenc", "tíz"]
    tens = ["", "tizen", "huszon", "harminc", "negyven", "ötven", "hatvan",
            "hetven", "nyolcvan", "kilencven"]

    def below100(k: int) -> str:
        if k <= 10:
            return units[k]
        if k < 20:
            return "tizen" + units[k - 10]
        if k == 20:
            return "húsz"
        t, u = divmod(k, 10)
        if t == 2:
            return "huszon" + units[u] if u else "húsz"
        return tens[t] + (units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        out = ""
        if h:
            out += ("" if h == 1 else units[h]) + "száz"
        if r:
            out += below100(r)
        return out

    if n == 0:
        return "nulla"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("egy" if bill == 1 else below1000(bill)) + "milliárd")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("egy" if mill == 1 else below1000(mill)) + "millió")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th)) + "ezer")
    if rest2:
        parts.append(below1000(rest2))
    return "".join(parts) if n < 2000 else " ".join(parts)


def _id(n: int) -> str:
    units = ["nol", "satu", "dua", "tiga", "empat", "lima", "enam",
             "tujuh", "delapan", "sembilan"]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append("seratus" if h == 1 else units[h] + " ratus")
        if r:
            if r < 10:
                parts.append(units[r])
            elif r == 10:
                parts.append("sepuluh")
            elif r == 11:
                parts.append("sebelas")
            elif r < 20:
                parts.append(units[r - 10] + " belas")
            else:
                t, u = divmod(r, 10)
                parts.append(units[t] + " puluh" + (" " + units[u] if u else ""))
        return " ".join(parts)

    if n == 0:
        return "nol"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("satu" if bill == 1 else below1000(bill)) + " miliar")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("satu" if mill == 1 else below1000(mill)) + " juta")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append("seribu" if th == 1 else below1000(th) + " ribu")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _vi(n: int) -> str:
    units = ["không", "một", "hai", "ba", "bốn", "năm", "sáu", "bảy",
             "tám", "chín"]

    def below100(k: int) -> str:
        if k < 10:
            return units[k]
        t, u = divmod(k, 10)
        if t == 1:
            head = "mười"
            if u == 5:
                return "mười lăm"
            return head + (" " + units[u] if u else "")
        head = units[t] + " mươi"
        if u == 0:
            return head
        if u == 1:
            return head + " mốt"
        if u == 5:
            return head + " lăm"
        return head + " " + units[u]

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        out = ""
        if h:
            out = units[h] + " trăm"
            if r and r < 10:
                out += " lẻ " + units[r]
            elif r:
                out += " " + below100(r)
            return out
        return below100(r)

    if n == 0:
        return "không"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(below1000(bill) + " tỷ")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(below1000(mill) + " triệu")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(below1000(th) + " nghìn")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _ro(n: int) -> str:
    units = ["zero", "unu", "doi", "trei", "patru", "cinci", "șase",
             "șapte", "opt", "nouă", "zece", "unsprezece", "doisprezece",
             "treisprezece", "paisprezece", "cincisprezece", "șaisprezece",
             "șaptesprezece", "optsprezece", "nouăsprezece"]
    tens = ["", "", "douăzeci", "treizeci", "patruzeci", "cincizeci",
            "șaizeci", "șaptezeci", "optzeci", "nouăzeci"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        return tens[t] + (" și " + units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append("o sută" if h == 1 else units[h] + " sute")
        if r:
            parts.append(below100(r))
        return " ".join(parts)

    if n == 0:
        return "zero"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append("un miliard" if bill == 1 else below1000(bill) + " miliarde")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append("un milion" if mill == 1 else below1000(mill) + " milioane")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append("o mie" if th == 1 else below1000(th) + " mii")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _sw(n: int) -> str:
    units = ["sifuri", "moja", "mbili", "tatu", "nne", "tano", "sita",
             "saba", "nane", "tisa"]
    tens = ["", "kumi", "ishirini", "thelathini", "arobaini", "hamsini",
            "sitini", "sabini", "themanini", "tisini"]

    def below100(k: int) -> str:
        if k < 10:
            return units[k]
        t, u = divmod(k, 10)
        return tens[t] + (" na " + units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append("mia " + units[h])
        if r:
            parts.append(("na " if h else "") + below100(r))
        return " ".join(parts)

    if n == 0:
        return "sifuri"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append("bilioni " + below1000(bill))
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append("milioni " + below1000(mill))
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append("elfu " + below1000(th))
    if rest2:
        parts.append(("na " if parts else "") + below1000(rest2))
    return " ".join(parts)


_UR_0_99 = (
    "صفر ایک دو تین چار پانچ چھ سات آٹھ نو دس "
    "گیارہ بارہ تیرہ چودہ پندرہ سولہ سترہ اٹھارہ انیس بیس "
    "اکیس بائیس تئیس چوبیس پچیس چھبیس ستائیس اٹھائیس انتیس تیس "
    "اکتیس بتیس تینتیس چونتیس پینتیس چھتیس سینتیس اڑتیس انتالیس چالیس "
    "اکتالیس بیالیس تینتالیس چوالیس پینتالیس چھیالیس سینتالیس اڑتالیس انچاس پچاس "
    "اکاون باون ترپن چون پچپن چھپن ستاون اٹھاون انسٹھ ساٹھ "
    "اکسٹھ باسٹھ ترسٹھ چونسٹھ پینسٹھ چھیاسٹھ سڑسٹھ اڑسٹھ انہتر ستر "
    "اکہتر بہتر تہتر چوہتر پچہتر چھہتر ستتر اٹھہتر اناسی اسی "
    "اکیاسی بیاسی تراسی چوراسی پچاسی چھیاسی ستاسی اٹھاسی نواسی نوے "
    "اکانوے بانوے ترانوے چورانوے پچانوے چھیانوے ستانوے اٹھانوے ننانوے"
).split()


def _ur(n: int) -> str:
    """Urdu cardinals (same Indian grouping as Hindi: سو/ہزار/لاکھ/کروڑ)."""
    if n < 100:
        return _UR_0_99[n]
    parts = []
    crore, rest = divmod(n, 10**7)
    if crore:
        parts.append(_ur(crore) + " کروڑ")
    lakh, rest = divmod(rest, 10**5)
    if lakh:
        parts.append(_UR_0_99[lakh] + " لاکھ")
    th, rest = divmod(rest, 1000)
    if th:
        parts.append(_UR_0_99[th] + " ہزار")
    h, rest = divmod(rest, 100)
    if h:
        parts.append(_UR_0_99[h] + " سو")
    if rest:
        parts.append(_UR_0_99[rest])
    return " ".join(parts)


def _bg(n: int) -> str:
    units = ["нула", "едно", "две", "три", "четири", "пет", "шест", "седем",
             "осем", "девет", "десет", "единадесет", "дванадесет",
             "тринадесет", "четиринадесет", "петнадесет", "шестнадесет",
             "седемнадесет", "осемнадесет", "деветнадесет"]
    tens = ["", "", "двадесет", "тридесет", "четиридесет", "петдесет",
            "шестдесет", "седемдесет", "осемдесет", "деветдесет"]
    hundreds = ["", "сто", "двеста", "триста", "четиристотин", "петстотин",
                "шестстотин", "седемстотин", "осемстотин", "деветстотин"]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append(hundreds[h])
        if r:
            if r < 20:
                parts.append(("и " if h else "") + units[r] if h and r < 10 else units[r])
            else:
                t, u = divmod(r, 10)
                parts.append(tens[t] + (" и " + units[u] if u else ""))
        return " ".join(parts)

    if n == 0:
        return "нула"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append("милиард" if bill == 1 else below1000(bill) + " милиарда")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append("милион" if mill == 1 else below1000(mill) + " милиона")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append("хиляда" if th == 1 else below1000(th) + " хиляди")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _sh(n: int, thousand=("tisuća", "tisuće", "tisuća"),
        million=("milijun", "milijuna", "milijuna"),
        billion=("milijarda", "milijarde", "milijardi"),
        two_fem="dvije") -> str:
    """Croatian/Bosnian/Serbian (Latin) shared speller."""
    units = ["nula", "jedan", "dva", "tri", "četiri", "pet", "šest",
             "sedam", "osam", "devet", "deset", "jedanaest", "dvanaest",
             "trinaest", "četrnaest", "petnaest", "šesnaest", "sedamnaest",
             "osamnaest", "devetnaest"]
    tens = ["", "", "dvadeset", "trideset", "četrdeset", "pedeset",
            "šezdeset", "sedamdeset", "osamdeset", "devedeset"]
    hundreds = ["", "sto", "dvjesto", "tristo", "četiristo", "petsto",
                "šesto", "sedamsto", "osamsto", "devetsto"]

    def agree(k, forms):
        if k % 100 in (11, 12, 13, 14):
            return forms[2]
        if k % 10 == 1:
            return forms[0]
        if k % 10 in (2, 3, 4):
            return forms[1]
        return forms[2]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append(hundreds[h])
        if r:
            if r < 20:
                parts.append(units[r])
            else:
                t, u = divmod(r, 10)
                parts.append(tens[t] + (" " + units[u] if u else ""))
        return " ".join(parts)

    if n == 0:
        return "nula"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        head = below1000(bill) if bill > 1 else "jedna"
        parts.append(head + " " + agree(bill, billion))
    mill, rest = divmod(n, 10**6)
    if mill:
        head = below1000(mill) if mill > 1 else "jedan"
        parts.append(head + " " + agree(mill, million))
    th, rest2 = divmod(rest, 1000)
    if th:
        head = below1000(th) if th > 1 else "jedna"
        # thousand is feminine: trailing dva → dvije/dve (dvije tisuće)
        if th % 10 == 2 and th % 100 != 12 and head.endswith("dva"):
            head = head[:-3] + two_fem
        parts.append(head + " " + agree(th, thousand))
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _sr(n: int) -> str:
    return _sh(n, thousand=("hiljada", "hiljade", "hiljada"),
               million=("milion", "miliona", "miliona"),
               billion=("milijarda", "milijarde", "milijardi"),
               two_fem="dve")


def _sl(n: int) -> str:
    units = ["nič", "ena", "dve", "tri", "štiri", "pet", "šest", "sedem",
             "osem", "devet", "deset", "enajst", "dvanajst", "trinajst",
             "štirinajst", "petnajst", "šestnajst", "sedemnajst",
             "osemnajst", "devetnajst"]
    cunits = ["", "en", "dva", "tri", "štiri", "pet", "šest", "sedem",
              "osem", "devet"]
    tens = ["", "", "dvajset", "trideset", "štirideset", "petdeset",
            "šestdeset", "sedemdeset", "osemdeset", "devetdeset"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        if not u:
            return tens[t]
        return cunits[u] + "in" + tens[t]  # petindvajset

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        out = ""
        if h:
            out += ("" if h == 1 else units[h] + " ") + "sto"
        if r:
            out += (" " if h else "") + below100(r)
        return out

    if n == 0:
        return "nič"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("ena" if bill == 1 else below1000(bill)) + " milijarda"
                     if bill == 1 else below1000(bill) + " milijard")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("en milijon" if mill == 1 else below1000(mill) + " milijonov"))
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "tisoč")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _sk(n: int) -> str:
    return _slavic(
        n,
        ["nula", "jeden", "dva", "tri", "štyri", "päť", "šesť", "sedem",
         "osem", "deväť"],
        ["desať", "jedenásť", "dvanásť", "trinásť", "štrnásť", "pätnásť",
         "šestnásť", "sedemnásť", "osemnásť", "devätnásť"],
        ["", "desať", "dvadsať", "tridsať", "štyridsať", "päťdesiat",
         "šesťdesiat", "sedemdesiat", "osemdesiat", "deväťdesiat"],
        ["", "sto", "dvesto", "tristo", "štyristo", "päťsto", "šesťsto",
         "sedemsto", "osemsto", "deväťsto"],
        ("tisíc", "tisíce", "tisíc"),
        ("milión", "milióny", "miliónov"),
        billion_forms=("miliarda", "miliardy", "miliárd"),
    )


def _et(n: int) -> str:
    units = ["null", "üks", "kaks", "kolm", "neli", "viis", "kuus",
             "seitse", "kaheksa", "üheksa", "kümme"]

    def below100(k: int) -> str:
        if k <= 10:
            return units[k]
        if k < 20:
            return units[k - 10] + "teist"
        t, u = divmod(k, 10)
        return units[t] + "kümmend" + (" " + units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        out = ""
        if h:
            out += ("" if h == 1 else units[h]) + "sada"
        if r:
            out += (" " if h else "") + below100(r)
        return out

    if n == 0:
        return "null"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("" if bill == 1 else below1000(bill) + " ") + "miljard" +
                     ("it" if bill > 1 else ""))
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("" if mill == 1 else below1000(mill) + " ") + "miljon" +
                     ("it" if mill > 1 else ""))
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "tuhat")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _ca(n: int) -> str:
    units = ["zero", "un", "dos", "tres", "quatre", "cinc", "sis", "set",
             "vuit", "nou", "deu", "onze", "dotze", "tretze", "catorze",
             "quinze", "setze", "disset", "divuit", "dinou"]
    tens = ["", "", "vint", "trenta", "quaranta", "cinquanta", "seixanta",
            "setanta", "vuitanta", "noranta"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        if not u:
            return tens[t]
        joiner = "-i-" if t == 2 else "-"  # vint-i-cinc, trenta-dos
        return tens[t] + joiner + units[u]

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append("cent" if h == 1 else units[h] + "-cents")
        if r:
            parts.append(below100(r))
        return " ".join(parts)

    if n == 0:
        return "zero"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("mil milions" if bill == 1
                      else below1000(bill) + " mil milions"))
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append("un milió" if mill == 1 else below1000(mill) + " milions")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append("mil" if th == 1 else below1000(th) + " mil")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _az(n: int) -> str:
    units = ["sıfır", "bir", "iki", "üç", "dörd", "beş", "altı", "yeddi",
             "səkkiz", "doqquz"]
    tens = ["", "on", "iyirmi", "otuz", "qırx", "əlli", "altmış", "yetmiş",
            "səksən", "doxsan"]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append(("" if h == 1 else units[h] + " ") + "yüz")
        t, u = divmod(r, 10)
        if t:
            parts.append(tens[t])
        if u:
            parts.append(units[u])
        return " ".join(parts)

    if n == 0:
        return "sıfır"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("bir" if bill == 1 else below1000(bill)) + " milyard")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("bir" if mill == 1 else below1000(mill)) + " milyon")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "min")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _af(n: int) -> str:
    units = ["nul", "een", "twee", "drie", "vier", "vyf", "ses", "sewe",
             "agt", "nege", "tien", "elf", "twaalf", "dertien", "veertien",
             "vyftien", "sestien", "sewentien", "agtien", "negentien"]
    tens = ["", "", "twintig", "dertig", "veertig", "vyftig", "sestig",
            "sewentig", "tagtig", "negentig"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        if not u:
            return tens[t]
        return units[u] + "-en-" + tens[t]  # vyf-en-twintig

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        out = ""
        if h:
            out += ("" if h == 1 else units[h] + " ") + "honderd"
        if r:
            out += (" " if h else "") + below100(r)
        return out

    if n == 0:
        return "nul"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("een" if bill == 1 else below1000(bill)) + " miljard")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("een" if mill == 1 else below1000(mill)) + " miljoen")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "duisend")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _is(n: int) -> str:
    units = ["núll", "einn", "tveir", "þrír", "fjórir", "fimm", "sex",
             "sjö", "átta", "níu", "tíu", "ellefu", "tólf", "þrettán",
             "fjórtán", "fimmtán", "sextán", "sautján", "átján", "nítján"]
    tens = ["", "", "tuttugu", "þrjátíu", "fjörutíu", "fimmtíu", "sextíu",
            "sjötíu", "áttatíu", "níutíu"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        return tens[t] + (" og " + units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append(("" if h == 1 else units[h] + " ") + "hundrað")
        if r:
            parts.append(("og " if h else "") + below100(r))
        return " ".join(parts)

    if n == 0:
        return "núll"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("" if bill == 1 else below1000(bill) + " ") + "milljarður"
                     if bill == 1 else below1000(bill) + " milljarðar")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append("milljón" if mill == 1 else below1000(mill) + " milljónir")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "þúsund")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _eo(n: int) -> str:
    units = ["nul", "unu", "du", "tri", "kvar", "kvin", "ses", "sep",
             "ok", "naŭ"]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append(("" if h == 1 else units[h]) + "cent")
        t, u = divmod(r, 10)
        if t:
            parts.append(("" if t == 1 else units[t]) + "dek")
        if u:
            parts.append(units[u])
        return " ".join(parts)

    if n == 0:
        return "nul"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("" if bill == 1 else below1000(bill) + " ") + "miliardo" +
                     ("j" if bill > 1 else ""))
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("" if mill == 1 else below1000(mill) + " ") + "miliono" +
                     ("j" if mill > 1 else ""))
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "mil")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _eu(n: int) -> str:
    """Basque (vigesimal 20..99)."""
    units = ["zero", "bat", "bi", "hiru", "lau", "bost", "sei", "zazpi",
             "zortzi", "bederatzi", "hamar", "hamaika", "hamabi",
             "hamahiru", "hamalau", "hamabost", "hamasei", "hamazazpi",
             "hemezortzi", "hemeretzi"]
    scores = ["", "hogei", "berrogei", "hirurogei", "laurogei"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        v, r = divmod(k, 20)
        if not r:
            return scores[v]
        return scores[v] + "ta " + units[r]  # hogeita bost

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append(("" if h == 1 else units[h] + " ") + "ehun")
        if r:
            parts.append(("eta " if h else "") + below100(r))
        return " ".join(parts)

    if n == 0:
        return "zero"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(below1000(bill) + " mila milioi")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("milioi bat" if mill == 1 else below1000(mill) + " milioi"))
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "mila")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _cy(n: int) -> str:
    """Welsh (modern decimal counting forms)."""
    units = ["dim", "un", "dau", "tri", "pedwar", "pump", "chwech",
             "saith", "wyth", "naw"]
    tens = ["", "deg", "dau ddeg", "tri deg", "pedwar deg", "pum deg",
            "chwe deg", "saith deg", "wyth deg", "naw deg"]

    def below100(k: int) -> str:
        if k < 10:
            return units[k]
        t, u = divmod(k, 10)
        if t == 1 and not u:
            return "deg"
        if t == 1:
            return "un deg " + units[u]
        return tens[t] + (" " + units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append(("" if h == 1 else units[h] + " ") + "cant")
        if r:
            parts.append(below100(r))
        return " ".join(parts)

    if n == 0:
        return "dim"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(below1000(bill) + " biliwn")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("" if mill == 1 else below1000(mill) + " ") + "miliwn")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "mil")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _mt(n: int) -> str:
    """Maltese (units-before-tens with u)."""
    units = ["żero", "wieħed", "tnejn", "tlieta", "erbgħa", "ħamsa",
             "sitta", "sebgħa", "tmienja", "disgħa", "għaxra", "ħdax",
             "tnax", "tlettax", "erbatax", "ħmistax", "sittax", "sbatax",
             "tmintax", "dsatax"]
    tens = ["", "", "għoxrin", "tletin", "erbgħin", "ħamsin", "sittin",
            "sebgħin", "tmenin", "disgħin"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        if not u:
            return tens[t]
        return units[u] + " u " + tens[t]  # ħamsa u għoxrin

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append("mija" if h == 1 else units[h] + " mija")
        if r:
            parts.append(("u " if h else "") + below100(r))
        return " ".join(parts)

    if n == 0:
        return "żero"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("" if bill == 1 else below1000(bill) + " ") + "biljun")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("" if mill == 1 else below1000(mill) + " ") + "miljun")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append("elf" if th == 1 else below1000(th) + " elf")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _lv(n: int) -> str:
    units = ["nulle", "viens", "divi", "trīs", "četri", "pieci", "seši",
             "septiņi", "astoņi", "deviņi", "desmit"]

    def below100(k: int) -> str:
        if k <= 10:
            return units[k]
        if k < 20:
            stems = ["", "vien", "div", "trīs", "četr", "piec", "seš",
                     "septiņ", "astoņ", "deviņ"]
            return stems[k - 10] + "padsmit"
        t, u = divmod(k, 10)
        stems = ["", "", "div", "trīs", "četr", "piec", "seš", "septiņ",
                 "astoņ", "deviņ"]
        return stems[t] + "desmit" + (" " + units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append("simts" if h == 1 else units[h] + " simti")
        if r:
            parts.append(below100(r))
        return " ".join(parts)

    if n == 0:
        return "nulle"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("miljards" if bill == 1 else below1000(bill) + " miljardi"))
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("miljons" if mill == 1 else below1000(mill) + " miljoni"))
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("tūkstotis" if th == 1 else below1000(th) + " tūkstoši"))
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _lt(n: int) -> str:
    units = ["nulis", "vienas", "du", "trys", "keturi", "penki", "šeši",
             "septyni", "aštuoni", "devyni", "dešimt"]
    teens = ["", "vienuolika", "dvylika", "trylika", "keturiolika",
             "penkiolika", "šešiolika", "septyniolika", "aštuoniolika",
             "devyniolika"]
    tens = ["", "dešimt", "dvidešimt", "trisdešimt", "keturiasdešimt",
            "penkiasdešimt", "šešiasdešimt", "septyniasdešimt",
            "aštuoniasdešimt", "devyniasdešimt"]

    def agree(k, forms):
        if k % 100 in (11, 12, 13, 14, 15, 16, 17, 18, 19):
            return forms[2]
        if k % 10 == 1:
            return forms[0]
        if k % 10 == 0:
            return forms[2]
        return forms[1]

    def below100(k: int) -> str:
        if k <= 10:
            return units[k]
        if k < 20:
            return teens[k - 10]
        t, u = divmod(k, 10)
        return tens[t] + (" " + units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append("šimtas" if h == 1 else units[h] + " šimtai")
        if r:
            parts.append(below100(r))
        return " ".join(parts)

    if n == 0:
        return "nulis"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(below1000(bill) + " " +
                     agree(bill, ("milijardas", "milijardai", "milijardų")))
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(below1000(mill) + " " +
                     agree(mill, ("milijonas", "milijonai", "milijonų")))
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(below1000(th) + " " +
                     agree(th, ("tūkstantis", "tūkstančiai", "tūkstančių")))
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _ga(n: int) -> str:
    """Irish (maths-register counting forms)."""
    units = ["náid", "a haon", "a dó", "a trí", "a ceathair", "a cúig",
             "a sé", "a seacht", "a hocht", "a naoi"]
    bare = ["", "haon", "dó", "trí", "ceathair", "cúig", "sé", "seacht",
            "hocht", "naoi"]
    tens = ["", "a deich", "fiche", "tríocha", "daichead", "caoga",
            "seasca", "seachtó", "ochtó", "nócha"]

    def below100(k: int) -> str:
        if k < 10:
            return units[k]
        if k == 10:
            return "a deich"
        if k < 20:
            return "a " + bare[k - 10] + " déag"
        t, u = divmod(k, 10)
        return tens[t] + (" a " + bare[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append("céad" if h == 1 else bare[h] + " chéad")
        if r:
            parts.append(below100(r))
        return " ".join(parts)

    if n == 0:
        return "náid"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(below1000(bill) + " billiún")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("milliún" if mill == 1 else below1000(mill) + " milliún"))
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("míle" if th == 1 else below1000(th) + " míle"))
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _hy(n: int) -> str:
    units = ["զրո", "մեկ", "երկու", "երեք", "չորս", "հինգ", "վեց", "յոթ",
             "ութ", "ինը", "տասը"]
    teen_stems = ["", "տասնմեկ", "տասներկու", "տասներեք", "տասնչորս",
                  "տասնհինգ", "տասնվեց", "տասնյոթ", "տասնութ", "տասնինը"]
    tens = ["", "", "քսան", "երեսուն", "քառասուն", "հիսուն", "վաթսուն",
            "յոթանասուն", "ութսուն", "իննսուն"]

    def below100(k: int) -> str:
        if k <= 10:
            return units[k]
        if k < 20:
            return teen_stems[k - 10]
        t, u = divmod(k, 10)
        return tens[t] + (units[u] if u else "")  # քսանհինգ joined

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append(("" if h == 1 else units[h] + " ") + "հարյուր")
        if r:
            parts.append(below100(r))
        return " ".join(parts)

    if n == 0:
        return "զրո"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("" if bill == 1 else below1000(bill) + " ") + "միլիարդ")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("" if mill == 1 else below1000(mill) + " ") + "միլիոն")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "հազար")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _ka(n: int) -> str:
    """Georgian (vigesimal 20..99)."""
    units = ["ნული", "ერთი", "ორი", "სამი", "ოთხი", "ხუთი", "ექვსი",
             "შვიდი", "რვა", "ცხრა", "ათი", "თერთმეტი", "თორმეტი",
             "ცამეტი", "თოთხმეტი", "თხუთმეტი", "თექვსმეტი", "ჩვიდმეტი",
             "თვრამეტი", "ცხრამეტი"]
    score_stems = ["", "ოც", "ორმოც", "სამოც", "ოთხმოც"]
    hundred_stems = ["", "ას", "ორას", "სამას", "ოთხას", "ხუთას", "ექვსას",
                     "შვიდას", "რვაას", "ცხრაას"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        v, r = divmod(k, 20)
        if not r:
            return score_stems[v] + "ი"  # ოცი, ორმოცი
        return score_stems[v] + "და" + units[r]  # ოცდახუთი

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        if not h:
            return below100(r)
        if not r:
            return hundred_stems[h] + "ი"  # ასი, ორასი
        return hundred_stems[h] + " " + below100(r)

    if n == 0:
        return "ნული"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("" if bill == 1 else below1000(bill) + " ") + "მილიარდი")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("" if mill == 1 else below1000(mill) + " ") + "მილიონი")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "ათასი")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _turkic_cyr(n: int, units, tens, hundred, thousand, zero,
                million="миллион", billion="миллиард") -> str:
    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append(("" if h == 1 else units[h] + " ") + hundred)
        t, u = divmod(r, 10)
        if t:
            parts.append(tens[t])
        if u:
            parts.append(units[u])
        return " ".join(parts)

    if n == 0:
        return zero
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("" if bill == 1 else below1000(bill) + " ") + billion)
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("" if mill == 1 else below1000(mill) + " ") + million)
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + thousand)
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _kk(n: int) -> str:
    return _turkic_cyr(
        n,
        ["", "бір", "екі", "үш", "төрт", "бес", "алты", "жеті", "сегіз",
         "тоғыз"],
        ["", "он", "жиырма", "отыз", "қырық", "елу", "алпыс", "жетпіс",
         "сексен", "тоқсан"],
        "жүз", "мың", "нөл")


def _ky(n: int) -> str:
    return _turkic_cyr(
        n,
        ["", "бир", "эки", "үч", "төрт", "беш", "алты", "жети", "сегиз",
         "тогуз"],
        ["", "он", "жыйырма", "отуз", "кырк", "элүү", "алтымыш",
         "жетимиш", "сексен", "токсон"],
        "жүз", "миң", "нөл")


def _tt(n: int) -> str:
    return _turkic_cyr(
        n,
        ["", "бер", "ике", "өч", "дүрт", "биш", "алты", "җиде", "сигез",
         "тугыз"],
        ["", "ун", "егерме", "утыз", "кырык", "илле", "алтмыш", "җитмеш",
         "сиксән", "туксан"],
        "йөз", "мең", "ноль")


def _am(n: int) -> str:
    units = ["ዜሮ", "አንድ", "ሁለት", "ሶስት", "አራት", "አምስት", "ስድስት",
             "ሰባት", "ስምንት", "ዘጠኝ", "አስር"]
    teens_head = "አስራ "
    tens = ["", "", "ሃያ", "ሰላሳ", "አርባ", "ሃምሳ", "ስልሳ", "ሰባ", "ሰማንያ",
            "ዘጠና"]

    def below100(k: int) -> str:
        if k <= 10:
            return units[k]
        if k < 20:
            return teens_head + units[k - 10]
        t, u = divmod(k, 10)
        return tens[t] + (" " + units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append(("" if h == 1 else units[h] + " ") + "መቶ")
        if r:
            parts.append(below100(r))
        return " ".join(parts)

    if n == 0:
        return "ዜሮ"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("" if bill == 1 else below1000(bill) + " ") + "ቢሊዮን")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("" if mill == 1 else below1000(mill) + " ") + "ሚሊዮን")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "ሺ")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _sq(n: int) -> str:
    units = ["zero", "një", "dy", "tre", "katër", "pesë", "gjashtë",
             "shtatë", "tetë", "nëntë", "dhjetë"]

    def below100(k: int) -> str:
        if k <= 10:
            return units[k]
        if k < 20:
            return units[k - 10] + "mbëdhjetë"
        t, u = divmod(k, 10)
        tens = ["", "", "njëzet", "tridhjetë", "dyzet", "pesëdhjetë",
                "gjashtëdhjetë", "shtatëdhjetë", "tetëdhjetë",
                "nëntëdhjetë"][t]
        return tens + (" e " + units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append(("një" if h == 1 else units[h]) + "qind")
        if r:
            parts.append(("e " if h else "") + below100(r))
        return " ".join(parts)

    if n == 0:
        return "zero"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("një" if bill == 1 else below1000(bill)) + " miliard")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("një" if mill == 1 else below1000(mill)) + " milion")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("një" if th == 1 else below1000(th)) + " mijë")
    if rest2:
        parts.append(below1000(rest2))
    return " e ".join(parts) if len(parts) > 1 else parts[0]


def _la(n: int) -> str:
    units = ["nulla", "unus", "duo", "tres", "quattuor", "quinque", "sex",
             "septem", "octo", "novem", "decem", "undecim", "duodecim",
             "tredecim", "quattuordecim", "quindecim", "sedecim",
             "septendecim", "duodeviginti", "undeviginti"]
    tens = ["", "", "viginti", "triginta", "quadraginta", "quinquaginta",
            "sexaginta", "septuaginta", "octoginta", "nonaginta"]
    hundreds = ["", "centum", "ducenti", "trecenti", "quadringenti",
                "quingenti", "sescenti", "septingenti", "octingenti",
                "nongenti"]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append(hundreds[h])
        if r:
            if r < 20:
                parts.append(units[r])
            else:
                t, u = divmod(r, 10)
                parts.append(tens[t] + (" " + units[u] if u else ""))
        return " ".join(parts)

    if n == 0:
        return "nulla"
    parts = []
    th, rest2 = divmod(n, 1000)
    if th:
        # Recursive milia for large counts (classical Latin has no standard
        # single word above milia; "duo milia milia" stays readable).
        parts.append("mille" if th == 1 else _la(th) + " milia")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _uz(n: int) -> str:
    units = ["nol", "bir", "ikki", "uch", "to'rt", "besh", "olti",
             "yetti", "sakkiz", "to'qqiz"]
    tens = ["", "o'n", "yigirma", "o'ttiz", "qirq", "ellik", "oltmish",
            "yetmish", "sakson", "to'qson"]

    def below1000(k: int) -> str:
        parts = []
        h, r = divmod(k, 100)
        if h:
            parts.append(("" if h == 1 else units[h] + " ") + "yuz")
        t, u = divmod(r, 10)
        if t:
            parts.append(tens[t])
        if u:
            parts.append(units[u])
        return " ".join(parts)

    if n == 0:
        return "nol"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("" if bill == 1 else below1000(bill) + " ") + "milliard")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("" if mill == 1 else below1000(mill) + " ") + "million")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "ming")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _mi(n: int) -> str:
    units = ["kore", "tahi", "rua", "toru", "whā", "rima", "ono", "whitu",
             "waru", "iwa"]

    def below100(k: int) -> str:
        if k < 10:
            return units[k]
        t, u = divmod(k, 10)
        head = "tekau" if t == 1 else units[t] + " tekau"
        return head + (" mā " + units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append(("" if h == 1 else units[h] + " ") + "rau")
        if r:
            parts.append(("mā " if h and r < 10 else "") + below100(r))
        return " ".join(parts)

    if n == 0:
        return "kore"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("" if bill == 1 else below1000(bill) + " ") + "piriona")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("" if mill == 1 else below1000(mill) + " ") + "miriona")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "mano")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _jbo(n: int) -> str:
    """Lojban reads numbers digit-by-digit by design."""
    digits = ["no", "pa", "re", "ci", "vo", "mu", "xa", "ze", "bi", "so"]
    return " ".join(digits[int(d)] for d in str(n))


def _ht(n: int) -> str:
    units = ["zewo", "en", "de", "twa", "kat", "senk", "sis", "sèt",
             "uit", "nèf", "dis", "onz", "douz", "trèz", "katòz", "kenz",
             "sèz", "disèt", "dizuit", "diznèf"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        if t in (2, 3, 4, 5, 6):
            name = ["", "", "ven", "trant", "karant", "senkant",
                    "swasant"][t]
            return name + (" " + units[u] if u else "")
        if t == 7:
            return "swasant " + units[10 + u] if u else "swasanndis"
        if t == 8:
            return "katreven" + (" " + units[u] if u else "")
        return "katreven " + units[10 + u] if u else "katrevendis"

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            parts.append(("" if h == 1 else units[h] + " ") + "san")
        if r:
            parts.append(below100(r))
        return " ".join(parts)

    if n == 0:
        return "zewo"
    parts = []
    bill, n = divmod(n, 10**9)
    if bill:
        parts.append(("en" if bill == 1 else below1000(bill)) + " milya")
    mill, rest = divmod(n, 10**6)
    if mill:
        parts.append(("en" if mill == 1 else below1000(mill)) + " milyon")
    th, rest2 = divmod(rest, 1000)
    if th:
        parts.append(("" if th == 1 else below1000(th) + " ") + "mil")
    if rest2:
        parts.append(below1000(rest2))
    return " ".join(parts)


def _te(n: int) -> str:
    """Telugu (Indian grouping; oblique stem before a continuing number)."""
    units = ["సున్నా", "ఒకటి", "రెండు", "మూడు", "నాలుగు", "అయిదు",
             "ఆరు", "ఏడు", "ఎనిమిది", "తొమ్మిది", "పది", "పదకొండు",
             "పన్నెండు", "పదమూడు", "పద్నాలుగు", "పదిహేను", "పదహారు",
             "పదిహేడు", "పద్దెనిమిది", "పంతొమ్మిది"]
    tens = ["", "", "ఇరవై", "ముప్పై", "నలభై", "యాభై", "అరవై", "డెబ్బై",
            "ఎనభై", "తొంభై"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        return tens[t] + (" " + units[u] if u else "")

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        parts = []
        if h:
            if h == 1:
                parts.append("వంద" if not r else "నూట")  # nūṭa + continuation
            else:
                parts.append(units[h] + (" వందలు" if not r else " వందల"))
        if r:
            parts.append(below100(r))
        return " ".join(parts)

    if n == 0:
        return "సున్నా"
    parts = []
    crore, rest = divmod(n, 10**7)
    if crore:
        parts.append(_te(crore) + (" కోట్లు" if not rest else " కోట్ల")
                     if crore > 1 else ("కోటి" if not rest else "కోటి"))
    lakh, rest2 = divmod(rest, 10**5)
    if lakh:
        if lakh == 1:
            parts.append("లక్ష")
        else:
            parts.append(below100(lakh) + (" లక్షలు" if not rest2 else " లక్షల"))
    th, rest3 = divmod(rest2, 1000)
    if th:
        if th == 1:
            parts.append("వెయ్యి" if not rest3 else "వెయ్యి")
        else:
            parts.append(below100(th) + (" వేలు" if not rest3 else " వేల"))
    if rest3:
        parts.append(below1000(rest3))
    return " ".join(parts)


# Tamil sandhi: a combining stem ends in consonant+ு (e.g. இருபத்து); a
# following vowel-initial unit merges, the independent vowel becoming a
# vowel sign on that consonant (இருபத்து + ஐந்து → இருபத்தைந்து).
_TA_VOWEL_SIGN = {"அ": "", "ஆ": "ா", "இ": "ி", "ஈ": "ீ", "உ": "ு",
                  "ஊ": "ூ", "எ": "ெ", "ஏ": "ே", "ஐ": "ை", "ஒ": "ொ",
                  "ஓ": "ோ"}


def _ta_join(stem: str, word: str) -> str:
    if word and word[0] in _TA_VOWEL_SIGN and stem.endswith("ு"):
        return stem[:-1] + _TA_VOWEL_SIGN[word[0]] + word[1:]
    return stem + word


def _ta(n: int) -> str:
    """Tamil (Indian grouping; full vowel-sandhi composition)."""
    units = ["பூஜ்ஜியம்", "ஒன்று", "இரண்டு", "மூன்று", "நான்கு",
             "ஐந்து", "ஆறு", "ஏழு", "எட்டு", "ஒன்பது", "பத்து",
             "பதினொன்று", "பன்னிரண்டு", "பதின்மூன்று", "பதினான்கு",
             "பதினைந்து", "பதினாறு", "பதினேழு", "பதினெட்டு",
             "பத்தொன்பது"]
    tens_final = ["", "பத்து", "இருபது", "முப்பது", "நாற்பது", "ஐம்பது",
                  "அறுபது", "எழுபது", "எண்பது", "தொண்ணூறு"]
    tens_stem = ["", "", "இருபத்து", "முப்பத்து", "நாற்பத்து", "ஐம்பத்து",
                 "அறுபத்து", "எழுபத்து", "எண்பத்து", "தொண்ணூற்று"]

    def below100(k: int) -> str:
        if k < 20:
            return units[k]
        t, u = divmod(k, 10)
        if not u:
            return tens_final[t]
        return _ta_join(tens_stem[t], units[u])

    hundreds_final = ["", "நூறு", "இருநூறு", "முந்நூறு", "நானூறு",
                      "ஐந்நூறு", "அறுநூறு", "எழுநூறு", "எண்ணூறு",
                      "தொள்ளாயிரம்"]
    hundreds_stem = ["", "நூற்று", "இருநூற்று", "முந்நூற்று", "நானூற்று",
                     "ஐந்நூற்று", "அறுநூற்று", "எழுநூற்று", "எண்ணூற்று",
                     "தொள்ளாயிரத்து"]

    def below1000(k: int) -> str:
        h, r = divmod(k, 100)
        if not h:
            return below100(r)
        if not r:
            return hundreds_final[h]
        return _ta_join(hundreds_stem[h], below100(r))

    if n == 0:
        return "பூஜ்ஜியம்"
    parts = []
    crore, rest = divmod(n, 10**7)
    if crore:
        parts.append(("" if crore == 1 else _ta(crore) + " ") + "கோடி")
    lakh, rest2 = divmod(rest, 10**5)
    if lakh:
        parts.append(("" if lakh == 1 else below100(lakh) + " ") + "லட்சம்"
                     if not (rest2) else
                     ("" if lakh == 1 else below100(lakh) + " ") + "லட்சத்து")
    th, rest3 = divmod(rest2, 1000)
    if th:
        if not rest3:
            parts.append("ஆயிரம்" if th == 1 else below1000(th) + " ஆயிரம்")
        else:
            head = "ஆயிரத்து" if th == 1 else below1000(th) + " ஆயிரத்து"
            parts.append(_ta_join(head, below1000(rest3)))
            return " ".join(parts)
    if rest3:
        parts.append(below1000(rest3))
    return " ".join(parts)


_HI_0_99 = (
    "शून्य एक दो तीन चार पाँच छह सात आठ नौ दस "
    "ग्यारह बारह तेरह चौदह पंद्रह सोलह सत्रह अठारह उन्नीस बीस "
    "इक्कीस बाईस तेईस चौबीस पच्चीस छब्बीस सत्ताईस अट्ठाईस उनतीस तीस "
    "इकतीस बत्तीस तैंतीस चौंतीस पैंतीस छत्तीस सैंतीस अड़तीस उनतालीस चालीस "
    "इकतालीस बयालीस तैंतालीस चौवालीस पैंतालीस छियालीस सैंतालीस अड़तालीस उनचास पचास "
    "इक्यावन बावन तिरपन चौवन पचपन छप्पन सत्तावन अट्ठावन उनसठ साठ "
    "इकसठ बासठ तिरसठ चौंसठ पैंसठ छियासठ सड़सठ अड़सठ उनहत्तर सत्तर "
    "इकहत्तर बहत्तर तिहत्तर चौहत्तर पचहत्तर छिहत्तर सतहत्तर अठहत्तर उनासी अस्सी "
    "इक्यासी बयासी तिरासी चौरासी पचासी छियासी सत्तासी अट्ठासी नवासी नब्बे "
    "इक्यानवे बानवे तिरानवे चौरानवे पचानवे छियानवे सत्तानवे अट्ठानवे निन्यानवे"
).split()


def _hi(n: int) -> str:
    """Hindi cardinals (Indian grouping: सौ/हज़ार/लाख/करोड़)."""
    if n < 100:
        return _HI_0_99[n]
    parts = []
    crore, rest = divmod(n, 10**7)
    if crore:
        parts.append(_hi(crore) + " करोड़")
    lakh, rest = divmod(rest, 10**5)
    if lakh:
        parts.append(_HI_0_99[lakh] + " लाख")
    th, rest = divmod(rest, 1000)
    if th:
        parts.append(_HI_0_99[th] + " हज़ार")
    h, rest = divmod(rest, 100)
    if h:
        parts.append(_HI_0_99[h] + " सौ")
    if rest:
        parts.append(_HI_0_99[rest])
    return " ".join(parts)


# Native-Korean numerals (counter-attributive forms for 1/2/3/4/20):
# 3개 is 세 개, not the Sino 삼개. Used for counting units up to 99.
_KO_NATIVE_UNITS = ["", "한", "두", "세", "네", "다섯", "여섯", "일곱",
                    "여덟", "아홉"]
_KO_NATIVE_TENS = ["", "열", "스무", "서른", "마흔", "쉰", "예순", "일흔",
                   "여든", "아흔"]
# Counters that take native numerals (the common everyday set).
_KO_NATIVE_COUNTERS_1 = set("개명권살번잔병장시달")
_KO_NATIVE_COUNTERS_2 = ("마리", "송이", "켤레", "시간", "사람", "그릇")


def _ko_native(n: int) -> str | None:
    """1..99 in native-Korean counting form (한/두/세/네…), else None."""
    if not 1 <= n <= 99:
        return None
    t, u = divmod(n, 10)
    if t and not u:
        return _KO_NATIVE_TENS[t]
    tens = ""
    if t:
        tens = "스물" if t == 2 else _KO_NATIVE_TENS[t]
    return tens + _KO_NATIVE_UNITS[u]


def _ko(n: int) -> str:
    """Sino-Korean cardinals (일/이/삼 · 십/백/천 · 만/억)."""
    digits = ["", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]

    def below10000(k: int) -> str:
        out = ""
        for div, name in ((1000, "천"), (100, "백"), (10, "십")):
            d, k = divmod(k, div)
            if d:
                out += ("" if d == 1 else digits[d]) + name
        if k:
            out += digits[k]
        return out

    if n == 0:
        return "영"
    parts = []
    eok, rest = divmod(n, 10**8)
    if eok:
        parts.append(below10000(eok) + "억")
    man, rest2 = divmod(rest, 10**4)
    if man:
        parts.append(below10000(man) + "만")
    if rest2:
        parts.append(below10000(rest2))
    return " ".join(parts)


# ---------------------------------------------------------------------------
# Registry + text-level localization
# ---------------------------------------------------------------------------

# base language code → (speller, decimal-separator word)
_SPELLERS = {
    "es": (_es, "coma"), "fr": (_fr, "virgule"), "de": (_de, "Komma"),
    "it": (_it, "virgola"), "pt": (_pt, "vírgula"), "nl": (_nl, "komma"),
    "ru": (_ru, "запятая"), "uk": (_uk, "кома"), "pl": (_pl, "przecinek"),
    "cs": (_cs, "celá"), "tr": (_tr, "virgül"), "sv": (_sv, "komma"),
    "da": (_da, "komma"), "nb": (_no, "komma"), "nn": (_no, "komma"),
    "no": (_no, "komma"), "ar": (_ar, "فاصلة"), "fa": (_fa, "ممیز"),
    "hi": (_hi, "दशमलव"), "ko": (_ko, "점"),
    "el": (_el, "κόμμα"), "fi": (_fi, "pilkku"), "hu": (_hu, "egész"),
    "id": (_id, "koma"), "ms": (_id, "perpuluhan"), "vi": (_vi, "phẩy"),
    "ro": (_ro, "virgulă"), "sw": (_sw, "nukta"), "ur": (_ur, "اعشاریہ"),
    "bg": (_bg, "цяло и"), "hr": (_sh, "zarez"), "bs": (_sr, "zarez"),
    "sr": (_sr, "zapeta"), "sl": (_sl, "vejica"), "sk": (_sk, "celá"),
    "et": (_et, "koma"), "ca": (_ca, "coma"), "az": (_az, "vergül"),
    "af": (_af, "komma"), "is": (_is, "komma"),
    "eo": (_eo, "komo"), "eu": (_eu, "koma"), "cy": (_cy, "pwynt"),
    "mt": (_mt, "punt"), "lv": (_lv, "komats"), "lt": (_lt, "kablelis"),
    "ga": (_ga, "pointe"), "hy": (_hy, "ստորակետ"), "ka": (_ka, "მძიმე"),
    "kk": (_kk, "бүтін"), "ky": (_ky, "бүтүн"), "tt": (_tt, "бөтен"),
    "am": (_am, "ነጥብ"), "sq": (_sq, "presje"), "la": (_la, "punctum"),
    "uz": (_uz, "butun"), "mi": (_mi, "ira"), "jbo": (_jbo, "pi"),
    "ht": (_ht, "pwen"), "te": (_te, "పాయింట్"), "ta": (_ta, "புள்ளி"),
}

# Eastern digit forms normalized to ASCII before matching.
_DIGIT_TRANS = str.maketrans(
    "٠١٢٣٤٥٦٧٨٩۰۱۲۳۴۵۶۷۸۹०१२३४५६७८९",
    "012345678901234567890123456789",
)

_INT_RE = re.compile(r"\d+")

# Languages where "." is the decimal separator and "," groups thousands
# (the en convention); everywhere else in the supported set the roles are
# swapped, so "3,141" is pi, not three thousand.
_PERIOD_DECIMAL = {"hi", "ur", "ko", "sw", "te", "ta"}


def supported(language: str) -> bool:
    if language.startswith("fa-latn"):
        return False  # romanized Persian: Arabic-script words would be dropped
    return language.split("-")[0] in _SPELLERS


def localize_numbers(text: str, language: str) -> str | None:
    """Replace digit runs with native number words; None if unsupported."""
    if not supported(language):
        return None
    base = language.split("-")[0]
    speller, decimal_word = _SPELLERS[base]
    text = text.translate(_DIGIT_TRANS)
    if base in _PERIOD_DECIMAL:
        group_re = re.compile(r"(\d)[,](\d{3})\b")
        dec_re = re.compile(r"(\d+)[.](\d+)")
    else:
        group_re = re.compile(r"(\d)[.](\d{3})\b")
        dec_re = re.compile(r"(\d+)[,](\d+)")
    # Thousands grouping collapses first (separator per locale).
    while group_re.search(text):
        text = group_re.sub(r"\1\2", text)

    def spell(n: int) -> str:
        if n >= 10**12:  # out of range: digit-by-digit
            return " ".join(speller(int(d)) for d in str(n))
        return speller(n)

    def dec_sub(m: re.Match) -> str:
        whole = spell(int(m.group(1)))
        frac = " ".join(speller(int(d)) for d in m.group(2))
        return f"{whole} {decimal_word} {frac}"

    text = dec_re.sub(dec_sub, text)
    if base == "ko":
        # Counter-aware native numerals: a small count directly before an
        # everyday counter reads natively (3개 → 세 개); other numbers stay
        # Sino-Korean.
        def ko_sub(m: re.Match) -> str:
            n = int(m.group(0))
            tail = text[m.end():m.end() + 2]
            if (tail[:2] in _KO_NATIVE_COUNTERS_2
                    or (tail[:1] and tail[:1] in _KO_NATIVE_COUNTERS_1)):
                native = _ko_native(n)
                if native is not None:
                    return native + " "
            return spell(n)

        text = _INT_RE.sub(ko_sub, text)
        return text
    text = _INT_RE.sub(lambda m: spell(int(m.group(0))), text)
    return text
