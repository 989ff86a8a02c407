"""The frozen G2P corpus of all 109 language codes, phonemized by the port's
text front end (the port's counterpart of ``tools/make_g2p_golden.py``).

    python -m zonos_tpu_torch.tools.make_g2p_golden --diff            # against tests/data/g2p_golden.json
    python -m zonos_tpu_torch.tools.make_g2p_golden --out g2p.json    # write a snapshot there

A fixed sentence set, for each code a plain sentence, digits where the
native number spellers apply and, for non-Latin scripts, an embedded Latin
run, goes through ``conditioning.espeak.phonemize`` (the native engines
where there is no libespeak-ng). ``--diff`` prints every entry whose IPA
differs from the repository's snapshot, then ``N changed entries``, and
returns 1 when N > 0. ``--out`` writes the corpus to the path given. The
repository's snapshot is written by the JAX package's tool only. Host code:
nothing runs on a device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

SNAPSHOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                        "tests", "data", "g2p_golden.json")

# fmt: off
SENTENCES: dict[str, list[str]] = {
    # --- English variants ---
    "en-us": ["The quick brown fox jumps over the lazy dog.",
              "In 1984 there were 365 days, 12 months and 52 weeks.",
              "Dr. Smith paid $25 for the subtle comb on Main Street."],
    "en-gb": ["The weather in London is rather unpredictable.",
              "He bought 3 apples and 20 oranges for £5."],
    "en-gb-scotland": ["The loch is deep and cold in winter."],
    "en-gb-x-gbclan": ["The train to Manchester leaves at nine."],
    "en-gb-x-gbcwmd": ["The canal runs through the old town."],
    "en-gb-x-rp": ["The orchestra performed splendidly last night."],
    "en-029": ["The island market opens early in the morning."],
    # --- Romance ---
    "es": ["El rápido zorro marrón salta sobre el perro perezoso.",
           "Tengo veintiún años y 365 libros.",
           "¿Cuánto cuesta? Cuesta 21 euros."],
    "es-419": ["Vamos a la playa el sábado por la tarde.",
               "Hay 100 personas en la fiesta."],
    "pt": ["O gato dorme na cadeira velha da cozinha.",
           "Comprei 42 livros em 2023."],
    "pt-br": ["A praia estava cheia de gente no domingo.",
              "São 15 horas e 30 minutos."],
    "fr-fr": ["Le petit garçon mange une pomme rouge.",
              "C'est la porte de l'hôtel, il y a 80 chambres.",
              "Quatre-vingt-dix-neuf mille francs."],
    "fr-be": ["Il fait beau aujourd'hui à Bruxelles.",
              "Nonante personnes attendent le tram."],
    "fr-ch": ["La montagne est couverte de neige fraîche."],
    "it": ["La piazza era piena di piccioni stamattina.",
           "Ho comprato 22 bottiglie di acqua frizzante."],
    "ro": ["Copilul se joacă în grădina bunicii.",
           "Am citit 14 cărți anul trecut."],
    "ca": ["El nen menja pa amb tomàquet cada matí.",
           "Hi ha 31 dies al mes de gener."],
    "an": ["O zagal chugaba en a plaza gran."],
    "la": ["Gallia est omnis divisa in partes tres.",
           "Anno Domini 2024."],
    "pap": ["E mucha ta kome un apel kòrá."],
    "ht": ["Ti gason an ap manje yon pòm wouj.",
           "Gen 25 moun nan sal la."],
    # --- Germanic ---
    "de": ["Der schnelle braune Fuchs springt über den faulen Hund.",
           "Ich habe 1234 Bücher und 56 Stifte gekauft.",
           "Die Straße ist nass, aber die Sonne scheint schön."],
    "nl": ["De kat slaapt op de warme vensterbank.",
           "Er zijn 88 toetsen op een piano."],
    "sv": ["Räven hoppar över den lata hunden.",
           "Det finns 29 bokstäver i svenska alfabetet."],
    "nb": ["Gutten leser en spennende bok om kvelden.",
           "Det er 17 grader ute i dag."],
    "da": ["Pigen cykler gennem den gamle by.",
           "Der bor 43 mennesker i landsbyen."],
    "is": ["Hesturinn hleypur yfir grænu engin.",
           "Það eru 12 mánuðir í árinu."],
    "af": ["Die seun speel met sy hond in die tuin.",
           "Daar is 60 sekondes in 'n minuut."],
    # --- Slavic ---
    "ru": ["Быстрая коричневая лиса прыгает через ленивую собаку.",
           "В году 365 дней и 12 месяцев.",
           "Хорошо, что молоко стоит 50 рублей."],
    "ru-lv": ["Сегодня хорошая погода для прогулки."],
    "pl": ["Szybki brązowy lis przeskakuje nad leniwym psem.",
           "Mam 33 lata i dwóch braci."],
    "cs": ["Rychlá hnědá liška skáče přes líného psa.",
           "V roce je 52 týdnů."],
    "sk": ["Rýchla hnedá líška skáče cez lenivého psa.",
           "Mesto má 95 tisíc obyvateľov."],
    "sl": ["Hitra rjava lisica skače čez lenega psa.",
           "Teden ima 7 dni."],
    "hr": ["Brza smeđa lisica skače preko lijenog psa.",
           "Godina ima 365 dana."],
    "bs": ["Dječak čita knjigu pored prozora."],
    "sr": ["Брза смеђа лисица скаче преко лењог пса.",
           "Brza smeđa lisica skače preko lenjog psa.",
           "У години има 12 месеци."],
    "bg": ["Бързата кафява лисица прескача мързеливото куче.",
           "Имам 28 години и живея в София."],
    "mk": ["Брзата кафеава лисица скока преку мрзливото куче.",
           "Во неделата има 7 дена."],
    # --- Baltic ---
    "lt": ["Greita ruda lapė šoka per tingų šunį.",
           "Metuose yra 365 dienos."],
    "lv": ["Ātrā brūnā lapsa lec pāri slinkajam sunim.",
           "Nedēļā ir 7 dienas."],
    # --- Celtic ---
    "ga": ["Tá an sionnach donn ag léim thar an madra leisciúil.",
           "Tá 32 contae in Éirinn."],
    "gd": ["Tha an t-sionnach a' leum thairis air a' chù.",
           "Tha 18 aibidil anns a' Ghàidhlig."],
    "cy": ["Mae'r llwynog brown yn neidio dros y ci diog.",
           "Mae 28 diwrnod ym mis Chwefror."],
    # --- Greek ---
    "el": ["Η γρήγορη καφέ αλεπού πηδά πάνω από τον τεμπέλη σκύλο.",
           "Έχω 30 βιβλία στο σπίτι μου.",
           "Το laptop είναι στο τραπέζι."],
    "grc": ["Ἐν ἀρχῇ ἦν ὁ λόγος, καὶ ὁ λόγος ἦν πρὸς τὸν θεόν."],
    # --- Uralic / other European ---
    "fi": ["Nopea ruskea kettu hyppää laiskan koiran yli.",
           "Vuodessa on 365 päivää."],
    "et": ["Kiire pruun rebane hüppab üle laisa koera.",
           "Nädalas on 7 päeva."],
    "hu": ["A gyors barna róka átugrik a lusta kutyán.",
           "Egy évben 52 hét van."],
    "eu": ["Azeri azkarrak txakur alferraren gainetik salto egiten du.",
           "Asteak 7 egun ditu."],
    "mt": ["Il-volpi l-kannella taqbeż fuq il-kelb l-għażżien.",
           "Hemm 12-il xahar fis-sena."],
    "sq": ["Dhelpra e shpejtë kërcen mbi qenin përtac.",
           "Java ka 7 ditë."],
    # --- Turkic ---
    "tr": ["Hızlı kahverengi tilki tembel köpeğin üzerinden atlar.",
           "Bir yılda 365 gün vardır."],
    "az": ["Sürətli qəhvəyi tülkü tənbəl itin üstündən tullanır.",
           "Həftədə 7 gün var."],
    "uz": ["Tez jigarrang tulki dangasa itning ustidan sakraydi.",
           "Bir yilda 12 oy bor."],
    "kk": ["Жылдам қоңыр түлкі жалқау иттің үстінен секіреді.",
           "Бір жылда 365 күн бар."],
    "ky": ["Тез күрөң түлкү жалкоо иттин үстүнөн секирет.",
           "Бир жумада 7 күн бар."],
    "tt": ["Җитез көрән төлке ялкау эт өстеннән сикерә.",
           "Бер елда 12 ай бар."],
    "ba": ["Йылдам көрән төлкө ялҡау эт өҫтөнән һикерә."],
    # --- Armenian / Georgian / Caucasus ---
    "hy": ["Արագ շագանակագույն աղվեսը ցատկում է ծույլ շան վրայով։",
           "Տարին ունի 365 օր։"],
    "hyw": ["Արագ աղուէսը կը ցատկէ ծոյլ շան վրայէն։"],
    "ka": ["სწრაფი ყავისფერი მელა ხტება ზარმაც ძაღლზე.",
           "წელიწადში 365 დღეა."],
    # --- Semitic ---
    "ar": ["الثعلب البني السريع يقفز فوق الكلب الكسول.",
           "في السنة 365 يوما و 12 شهرا.",
           "كتب الولد الدرس في المدرسة."],
    "am": ["ፈጣኑ ቡናማ ቀበሮ ሰነፉን ውሻ ይዘላል።",
           "በዓመት 365 ቀናት አሉ።"],
    # --- Iranian / Indo-Aryan (Perso-Arabic) ---
    "fa": ["روباه قهوه‌ای سریع از روی سگ تنبل می‌پرد.",
           "در سال 365 روز وجود دارد."],
    "fa-latn": ["rubāhe qahvei az ruye sage tanbal miparad."],
    "ur": ["تیز بھورا لومڑی سست کتے کے اوپر سے چھلانگ لگاتی ہے۔",
           "سال میں 365 دن ہوتے ہیں۔"],
    "sd": ["تکڙو ناسي لومڙ سست ڪتي مٿان ٽپو ڏئي ٿو."],
    "ku": ["Rovîyê qehweyî yê bilez li ser kûçikê tiral baz dide.",
           "Di salekê de 365 roj hene."],
    # --- Indic (Brahmic scripts) ---
    "hi": ["तेज़ भूरी लोमड़ी आलसी कुत्ते के ऊपर से कूदती है।",
           "एक साल में 365 दिन होते हैं।",
           "मेरा computer नया है।"],
    "mr": ["वेगवान तपकिरी कोल्हा आळशी कुत्र्यावरून उडी मारतो.",
           "आठवड्यात 7 दिवस असतात."],
    "ne": ["छिटो खैरो फ्याउरो अल्छी कुकुरमाथि उफ्रिन्छ।",
           "एक वर्षमा 365 दिन हुन्छन्।"],
    "bn": ["দ্রুত বাদামি শিয়াল অলস কুকুরের উপর দিয়ে লাফ দেয়।",
           "এক বছরে 365 দিন থাকে।"],
    "as": ["ক্ষিপ্ৰ মুগা শিয়ালটোৱে এলেহুৱা কুকুৰটোৰ ওপৰেদি জপিয়াই।"],
    "bpy": ["এহান লামসাম ঠারর বাক্য আহান।"],
    "pa": ["ਤੇਜ਼ ਭੂਰੀ ਲੂੰਬੜੀ ਆਲਸੀ ਕੁੱਤੇ ਉੱਤੋਂ ਛਾਲ ਮਾਰਦੀ ਹੈ।",
           "ਹਫ਼ਤੇ ਵਿੱਚ 7 ਦਿਨ ਹੁੰਦੇ ਹਨ।"],
    "gu": ["ઝડપી ભૂરું શિયાળ આળસુ કૂતરા પરથી કૂદે છે.",
           "અઠવાડિયામાં 7 દિવસ હોય છે."],
    "or": ["ଦ୍ରୁତ ବାଦାମୀ କୋକିଶିଆଳି ଅଳସୁଆ କୁକୁର ଉପରେ ଡେଇଁଯାଏ।"],
    "ta": ["வேகமான பழுப்பு நரி சோம்பேறி நாயின் மேல் குதிக்கிறது.",
           "ஒரு வாரத்தில் 7 நாட்கள் உள்ளன."],
    "te": ["వేగవంతమైన గోధుమ నక్క సోమరి కుక్కపైనుంచి దూకుతుంది.",
           "సంవత్సరంలో 365 రోజులు ఉంటాయి."],
    "kn": ["ವೇಗದ ಕಂದು ನರಿ ಸೋಮಾರಿ ನಾಯಿಯ ಮೇಲೆ ಹಾರುತ್ತದೆ.",
           "ವಾರದಲ್ಲಿ 7 ದಿನಗಳಿವೆ."],
    "ml": ["വേഗതയുള്ള തവിട്ടു കുറുക്കൻ മടിയനായ നായയുടെ മുകളിലൂടെ ചാടുന്നു.",
           "ഒരാഴ്ചയിൽ 7 ദിവസങ്ങളുണ്ട്."],
    "kok": ["वेगान धांवपी कोलो आळशी सुण्याचेर उडकी मारता."],
    "si": ["වේගවත් දුඹුරු නරියා කම්මැලි බල්ලා උඩින් පනියි.",
           "සතියක දින 7 ක් ඇත."],
    # --- Southeast Asian ---
    "my": ["လျင်မြန်သော အညိုရောင် မြေခွေးသည် ပျင်းရိသော ခွေးကို ကျော်ခုန်သည်။"],
    "shn": ["မႃႇၼႆႉ ၵျေႃႇလႅၼ်ႈ ၼႂ်းသူၼ်။"],
    "vi": ["Con cáo nâu nhanh nhẹn nhảy qua con chó lười biếng.",
           "Một tuần có 7 ngày."],
    "vi-vn-x-central": ["Hôm nay trời đẹp quá."],
    "vi-vn-x-south": ["Cà phê sữa đá ngon lắm."],
    "id": ["Rubah coklat yang cepat melompati anjing yang malas.",
           "Ada 365 hari dalam setahun."],
    "ms": ["Rubah coklat pantas melompat di atas anjing malas.",
           "Seminggu ada 7 hari."],
    # --- East Asian ---
    "cmn": ["今天天气很好，我们一起去公园散步。",
            "一年有365天，十二个月。",
            "我的 computer 是新的。",
            "了解重庆的银行很重要。"],
    "hak": ["今晡日天气尽好。"],
    "yue": ["今日天氣好好，我哋去公園。",
            "一個星期有7日。",
            "我哋聽日去香港。"],
    "ja": ["速い茶色のきつねはのろまな犬の上を飛びます。",
           "一年は365日、十二ヶ月あります。",
           "私の computer は新しいです。",
           "来年の三月三日にまた来ます。"],
    "ko": ["빠른 갈색 여우가 게으른 개를 뛰어넘는다.",
           "일주일은 7일입니다.",
           "사과 세 개를 샀어요."],
    # --- African ---
    "sw": ["Mbweha mwepesi wa kahawia anaruka juu ya mbwa mvivu.",
           "Wiki ina siku 7."],
    "om": ["Sardiidni daalachi saffisaan saree dhibaaftuu irra utaala."],
    "tn": ["Phokojwe e e bonako e tlola ntša e e ditshwakga."],
    # --- Americas / constructed ---
    "gn": ["Aguara hũ akuáva opo jagua ateỹ ári."],
    "nci": ["In tototl patlani ipan in cuauhtla."],
    "quc": ["Ri par kaxik'an puwi' ri tz'i'."],
    "mi": ["Ka peke te pokiha parauri tere i runga i te kurī māngere.",
           "E 7 ngā rā o te wiki."],
    "eo": ["La rapida bruna vulpo saltas super la mallaborema hundo.",
           "Jaro havas 365 tagojn."],
    "ia": ["Le rapide vulpe brun salta super le can pigre."],
    "jbo": ["lo sutra xunre lorxu cu plipe fi lo lazni gerku"],
    "lfn": ["La volpe rapida brun salta supra la can pigra."],
    "py": ["suno lumen kanta melodi."],
    "kl": ["Terianniaq sukkasooq qimmeq eqiasuttoq qulaappaa."],
}
# fmt: on


def build() -> dict[str, list[dict]]:
    """{code: [{"text", "ipa"}, ...]} over every supported language code."""
    from zonos_tpu_torch.conditioning.cond_dict import supported_language_codes
    from zonos_tpu_torch.conditioning.espeak import phonemize

    missing = [c for c in supported_language_codes if c not in SENTENCES]
    assert not missing, f"no sentences for: {missing}"
    extra = [c for c in SENTENCES if c not in supported_language_codes]
    assert not extra, f"unknown codes: {extra}"
    golden = {}
    for code in supported_language_codes:
        texts = SENTENCES[code]
        ipas = phonemize(texts, [code] * len(texts))
        golden[code] = [{"text": t, "ipa": i} for t, i in zip(texts, ipas)]
    return golden


def diff(golden: dict, snapshot: dict) -> int:
    """Print each entry of ``golden`` that differs from ``snapshot``'s and the count; returns the count."""
    n = 0
    for code, rows in golden.items():
        for row, orow in zip(rows, snapshot.get(code, [])):
            if row != orow:
                n += 1
                print(f"[{code}] {row['text']}\n  old: {orow.get('ipa')}\n  new: {row['ipa']}")
    print(f"{n} changed entries")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--diff", action="store_true", help=f"compare with the snapshot {SNAPSHOT}")
    ap.add_argument("--out", help="write the corpus as JSON to this path")
    args = ap.parse_args(argv)
    if not (args.diff or args.out):
        print("one of --diff / --out is required", file=sys.stderr)
        return 2
    golden = build()
    status = 0
    if args.diff:
        with open(SNAPSHOT, encoding="utf-8") as f:
            status = int(diff(golden, json.load(f)) > 0)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(golden, f, ensure_ascii=False, indent=1)
        n = sum(len(v) for v in golden.values())
        print(f"wrote {n} entries for {len(golden)} codes → {args.out}")
    return status


if __name__ == "__main__":
    raise SystemExit(main())
