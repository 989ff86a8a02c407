"""Cantonese ("yue") reading fallback: hanzi → jyutping → IPA.

The reference resolves Cantonese through eSpeak NG ("yue"/"zh-yue" voices,
the reference's zonos/conditioning.py:291-335 + the language table
:525-536). When the espeak library is absent this module supplies true
Cantonese readings instead of the previous behaviour (routing through the
Mandarin tables with a warning):

* a jyutping lexicon of ~900 high-frequency characters in BOTH scripts
  (Cantonese text is usually traditional; the simplified forms are included
  so mainland-style input reads identically);
* a word lexicon for polyphones whose Cantonese reading differs by context
  (銀行 hong4 vs 自行車 hang4, 音樂 ngok6 vs 快樂 lok6, 重要 zung6 vs
  重複 cung4 — the same polyphone classes the Mandarin engine resolves);
* an exact numeral reader (零〜億 scale, 兩-selection before measure words);
* a regular jyutping → IPA mapping (Standard Cantonese initials/finals).
  TONES ARE EMITTED as Chao letters after each syllable (1 ˥, 2 ˧˥, 3 ˧,
  4 ˨˩, 5 ˩˧, 6 ˨) — the espeak IPA convention, same as the Mandarin and
  Vietnamese engines. Like those, tone letters sit outside the checkpoint's
  symbol table and map to UNK ids exactly as the reference's espeak path
  does (conditioning.py:240-241). Cantonese has no productive tone sandhi
  comparable to Mandarin's 3-3 rule, so none is applied.

Characters missing from the lexicon fall back to the MANDARIN reading
(conditioning/zh.py) with the tone digit stripped — an accented but
intelligible segment beats a dropped one — with one loud warning per
character; chars unknown to both tables are dropped with the same warning.
"""

from __future__ import annotations

import logging
import re

logger = logging.getLogger("zonos_tpu_torch")

# ---------------------------------------------------------------------------
# jyutping → IPA
# ---------------------------------------------------------------------------

_INITIALS = [
    ("gw", "kʷ"), ("kw", "kʷʰ"), ("ng", "ŋ"),
    ("b", "p"), ("p", "pʰ"), ("m", "m"), ("f", "f"),
    ("d", "t"), ("t", "tʰ"), ("n", "n"), ("l", "l"),
    ("g", "k"), ("k", "kʰ"), ("h", "h"), ("w", "w"),
    ("z", "ts"), ("c", "tsʰ"), ("s", "s"), ("j", "j"),
]

_FINALS = {
    "aai": "aːi", "aau": "aːu", "aam": "aːm", "aan": "aːn", "aang": "aːŋ",
    "aap": "aːp", "aat": "aːt", "aak": "aːk", "aa": "aː",
    "ai": "ɐi", "au": "ɐu", "am": "ɐm", "an": "ɐn", "ang": "ɐŋ",
    "ap": "ɐp", "at": "ɐt", "ak": "ɐk", "a": "ɐ",
    "ei": "ei", "eng": "ɛːŋ", "ek": "ɛːk", "em": "ɛːm", "ep": "ɛːp",
    "e": "ɛː",
    "iu": "iːu", "im": "iːm", "in": "iːn", "ing": "ɪŋ",
    "ip": "iːp", "it": "iːt", "ik": "ɪk", "i": "iː",
    "oi": "ɔːi", "ou": "ou", "on": "ɔːn", "ong": "ɔːŋ",
    "ot": "ɔːt", "ok": "ɔːk", "o": "ɔː",
    "ui": "uːi", "un": "uːn", "ung": "ʊŋ", "ut": "uːt", "uk": "ʊk",
    "u": "uː",
    "oeng": "œːŋ", "oek": "œːk", "oe": "œː",
    "eoi": "ɵy", "eon": "ɵn", "eot": "ɵt", "eo": "ɵ",
    "yun": "yːn", "yut": "yːt", "yu": "yː",
}

# Chao tone letters per jyutping tone digit (espeak IPA convention):
# 1 = 55 high, 2 = 35 rising, 3 = 33 mid, 4 = 21 low falling,
# 5 = 13 low rising, 6 = 22 low.
_TONE_IPA = {"1": "˥", "2": "˧˥", "3": "˧", "4": "˨˩", "5": "˩˧", "6": "˨"}


def jyutping_to_ipa(syllable: str) -> str:
    """One jyutping syllable (optional trailing tone digit 1-6) → IPA
    ('' for empty/unknown)."""
    s = syllable.strip().lower()
    tone = ""
    if s and s[-1] in _TONE_IPA:
        tone = _TONE_IPA[s[-1]]
        s = s[:-1]
    if not s:
        return ""
    # Syllabic nasals (唔 m4, 五/吳 ng5).
    if s == "m":
        return "m̩" + tone
    if s == "ng":
        return "ŋ̩" + tone
    ipa_init = ""
    for pin, ipa in _INITIALS:
        if s.startswith(pin):
            # "ng"/"m" as initial only when a final follows.
            if pin in ("ng", "m") and s == pin:
                break
            ipa_init = ipa
            s = s[len(pin):]
            break
    if s in _FINALS:
        return ipa_init + _FINALS[s] + tone
    # Unknown tail: emit what we can, letter by letter.
    plain = {"a": "ɐ", "e": "ɛ", "i": "i", "o": "ɔ", "u": "u",
             "m": "m", "n": "n", "g": "ŋ", "p": "p", "t": "t", "k": "k"}
    return ipa_init + "".join(plain.get(c, "") for c in s) + tone


# ---------------------------------------------------------------------------
# Numbers
# ---------------------------------------------------------------------------

_DIGIT_JP = ["ling4", "jat1", "ji6", "saam1", "sei3",
             "ng5", "luk6", "cat1", "baat3", "gau2"]


def number_to_jyutping(n: int, *, loeng: bool = False) -> str:
    """Non-negative integer → space-separated toned jyutping."""
    if n == 0:
        return "ling4"
    if n >= 10**12:
        return " ".join(_DIGIT_JP[int(c)] for c in str(n))

    def four(k: int, leading_unit: bool) -> list[str]:
        out: list[str] = []
        th, k2 = divmod(k, 1000)
        h, k3 = divmod(k2, 100)
        t, d = divmod(k3, 10)
        if th:
            out += [_DIGIT_JP[th], "cin1"]
            if not h and (t or d):
                out.append("ling4")
        if h:
            out += [_DIGIT_JP[h], "baak3"]
            if not t and d:
                out.append("ling4")
        if t:
            if t == 1 and not th and not h and leading_unit:
                out.append("sap6")
            else:
                out += [_DIGIT_JP[t], "sap6"]
        if d:
            out.append(_DIGIT_JP[d])
        return out

    groups: list[int] = []
    while n:
        n, g = divmod(n, 10000)
        groups.append(g)
    units = ["", "maan6", "jik1"]
    parts: list[str] = []
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if not g:
            continue
        seg = four(g, leading_unit=(i == len(groups) - 1))
        if units[i]:
            seg.append(units[i])
        parts += seg
    if loeng and parts == ["ji6"]:
        parts = ["loeng5"]
    return " ".join(parts)


# Measure words that prefer 兩 for 2 and are common after numerals.
_MEASURES = {"个": "go3", "個": "go3", "本": "bun2", "只": "zek3", "隻": "zek3",
             "条": "tiu4", "條": "tiu4", "张": "zoeng1", "張": "zoeng1",
             "件": "gin6", "位": "wai2", "名": "ming4", "岁": "seoi3",
             "歲": "seoi3", "年": "nin4", "月": "jyut6", "日": "jat6",
             "号": "hou6", "號": "hou6", "天": "tin1", "点": "dim2",
             "點": "dim2", "分": "fan1", "秒": "miu5",
             "小时": "siu2 si4", "小時": "siu2 si4",
             "分钟": "fan1 zung1", "分鐘": "fan1 zung1"}


# ---------------------------------------------------------------------------
# Word lexicon (polyphone disambiguation + high-frequency words).
# Keys list script variants separated by "/" (traditional usually first
# where the forms differ); values are space-separated toned jyutping.
# ---------------------------------------------------------------------------

_WORDS_SRC: dict[str, str] = {
    # 行 hang4/hong4
    "银行/銀行": "ngan4 hong4", "行业/行業": "hong4 jip6",
    "一行": "jat1 hong4", "行列": "hong4 lit6",
    "自行车/自行車": "zi6 hang4 ce1", "旅行": "leoi5 hang4",
    "行为/行為": "hang4 wai4", "进行/進行": "zeon3 hang4",
    "流行": "lau4 hang4", "行动/行動": "hang4 dung6",
    # 長 coeng4/zoeng2
    "长大/長大": "zoeng2 daai6", "校长/校長": "haau6 zoeng2",
    "长辈/長輩": "zoeng2 bui3", "成长/成長": "sing4 zoeng2",
    "队长/隊長": "deoi6 zoeng2", "市长/市長": "si5 zoeng2",
    "长城/長城": "coeng4 sing4", "长江/長江": "coeng4 gong1",
    "长期/長期": "coeng4 kei4", "长度/長度": "coeng4 dou6",
    # 重 cung5/cung4/zung6
    "重要": "zung6 jiu3", "重量": "cung5 loeng6", "严重/嚴重": "jim4 zung6",
    "重复/重複": "cung4 fuk1", "重新": "cung4 san1",
    # 樂 ngok6/lok6
    "音乐/音樂": "jam1 ngok6", "乐器/樂器": "ngok6 hei3",
    "快乐/快樂": "faai3 lok6", "乐观/樂觀": "lok6 gun1",
    # 覺 gok3/gaau3
    "睡觉/睡覺": "seoi6 gaau3", "感觉/感覺": "gam2 gok3",
    "觉得/覺得": "gok3 dak1",
    # 為 wai4/wai6
    "因为/因為": "jan1 wai6", "为了/為了": "wai6 liu5",
    "为什么/為什麼": "wai6 sam6 mo1",
    "认为/認為": "jing6 wai4", "成为/成為": "sing4 wai4",
    # 好 hou2/hou3
    "爱好/愛好": "oi3 hou3", "好奇": "hou3 kei4",
    # 間 gaan1/gaan3
    "时间/時間": "si4 gaan3", "房间/房間": "fong4 gaan1",
    "中间/中間": "zung1 gaan1",
    # 便 bin6/pin4
    "方便": "fong1 bin6", "便宜": "pin4 ji4", "顺便/順便": "seon6 bin2",
    # 都 dou1/dou1 (capital = dou1 in Cantonese too, no du split)
    "首都": "sau2 dou1", "都市": "dou1 si5",
    # 傳 cyun4/zyun6
    "传统/傳統": "cyun4 tung2", "传说/傳說": "cyun4 syut3",
    "自传/自傳": "zi6 zyun6",
    # 調 tiu4/diu6
    "调查/調查": "diu6 caa4", "调整/調整": "tiu4 zing2",
    "空调/空調": "hung1 tiu4",
    # 教 gaau3/gaau1
    "教育": "gaau3 juk6", "教师/教師": "gaau3 si1",
    "教室": "gaau3 sat1", "教学/教學": "gaau3 hok6",
    # 地 dei6 (not the Mandarin de particle)
    "地方": "dei6 fong1", "土地": "tou2 dei6",
    # high-frequency multi-char words
    "我们/我們": "ngo5 mun4", "你们/你們": "nei5 mun4",
    "他们/他們": "taa1 mun4", "她们/她們": "taa1 mun4",
    "什么/什麼": "sam6 mo1", "怎么/怎麼": "zam2 mo1",
    "这么/這麼": "ze2 mo1", "那么/那麼": "naa5 mo1",
    "没有/沒有": "mut6 jau5", "可以": "ho2 ji5", "知道": "zi1 dou3",
    "现在/現在": "jin6 zoi6", "今天": "gam1 tin1", "明天": "ming4 tin1",
    "昨天": "zok6 tin1", "今日": "gam1 jat6", "听日/聽日": "ting1 jat6",
    "中国/中國": "zung1 gwok3", "中文": "zung1 man4",
    "广东话/廣東話": "gwong2 dung1 waa2", "粤语/粵語": "jyut6 jyu5",
    "香港": "hoeng1 gong2", "北京": "bak1 ging1", "上海": "soeng6 hoi2",
    "多谢/多謝": "do1 ze6", "谢谢/謝謝": "ze6 ze6",
    "唔该/唔該": "m4 goi1", "你好": "nei5 hou2",
    "朋友": "pang4 jau5", "老师/老師": "lou5 si1",
    "学生/學生": "hok6 saang1", "学习/學習": "hok6 zaap6",
    "工作": "gung1 zok3", "时候/時候": "si4 hau6",
    "喜欢/喜歡": "hei2 fun1", "非常": "fei1 soeng4",
    "已经/已經": "ji5 ging1", "电脑/電腦": "din6 nou5",
    "电话/電話": "din6 waa2", "电影/電影": "din6 jing2",
    "世界": "sai3 gaai3", "大家": "daai6 gaa1", "东西/東西": "dung1 sai1",
    "先生": "sin1 saang1", "小姐": "siu2 ze2", "孩子": "haai4 zi2",
    "早上": "zou2 soeng6", "晚上": "maan5 soeng6", "中午": "zung1 ng5",
    "再见/再見": "zoi3 gin3", "飞机/飛機": "fei1 gei1",
    "火车/火車": "fo2 ce1", "自己": "zi6 gei2", "问题/問題": "man6 tai4",
    "开始/開始": "hoi1 ci2", "认识/認識": "jing6 sik1",
    "高兴/高興": "gou1 hing3", "苹果/蘋果": "ping4 gwo2",
    # Cantonese-specific vocabulary (written Cantonese)
    "几时/幾時": "gei2 si4", "点解/點解": "dim2 gaai2",
    "而家": "ji4 gaa1", "琴日": "kam4 jat6", "寻日/尋日": "cam4 jat6",
    "得闲/得閑/得閒": "dak1 haan4", "钟意/鍾意": "zung1 ji3",
    "犀利": "sai1 lei6",
}

WORDS: dict[str, str] = {}
for _ks, _v in _WORDS_SRC.items():
    for _k in _ks.split("/"):
        WORDS[_k] = _v

# ---------------------------------------------------------------------------
# Single-character jyutping (frequency-ranked core; both scripts).
# ---------------------------------------------------------------------------

_CHARS_SRC: dict[str, str] = {
    "的": "dik1", "一": "jat1", "是": "si6", "了": "liu5", "我": "ngo5",
    "不": "bat1", "在": "zoi6", "人": "jan4", "们/們": "mun4", "有": "jau5",
    "来/來": "loi4", "他": "taa1", "这/這": "ze2", "上": "soeng6",
    "着/著": "zoek6", "个/個": "go3", "地": "dei6", "到": "dou3",
    "大": "daai6", "里/裡/裏": "leoi5", "说/說": "syut3", "就": "zau6",
    "去": "heoi3", "子": "zi2", "得": "dak1", "也": "jaa5", "和": "wo4",
    "那": "naa5", "要": "jiu3", "下": "haa6", "看": "hon3", "天": "tin1",
    "时/時": "si4", "过/過": "gwo3", "出": "ceot1", "小": "siu2",
    "么/麼": "mo1", "起": "hei2", "你": "nei5", "都": "dou1", "把": "baa2",
    "好": "hou2", "还/還": "waan4", "多": "do1", "没/沒": "mut6",
    "为/為": "wai4", "又": "jau6", "可": "ho2", "家": "gaa1",
    "学/學": "hok6", "只": "zi2", "以": "ji5", "主": "zyu2",
    "会/會": "wui6", "样/樣": "joeng6", "年": "nin4", "想": "soeng2",
    "生": "sang1", "同": "tung4", "老": "lou5", "中": "zung1",
    "十": "sap6", "从/從": "cung4", "自": "zi6", "面": "min6",
    "前": "cin4", "头/頭": "tau4", "道": "dou6", "它": "taa1",
    "后/後": "hau6", "然": "jin4", "走": "zau2", "很": "han2",
    "像": "zoeng6", "见/見": "gin3", "两/兩": "loeng5", "用": "jung6",
    "她": "taa1", "国/國": "gwok3", "动/動": "dung6", "进/進": "zeon3",
    "成": "sing4", "回": "wui4", "什": "sam6", "边/邊": "bin1",
    "作": "zok3", "对/對": "deoi3", "开/開": "hoi1", "而": "ji4",
    "己": "gei2", "些": "se1", "现/現": "jin6", "山": "saan1",
    "民": "man4", "候": "hau6", "经/經": "ging1", "发/發": "faat3",
    "工": "gung1", "向": "hoeng3", "事": "si6", "命": "ming6",
    "给/給": "kap1", "长/長": "coeng4", "水": "seoi2", "几/幾": "gei2",
    "义/義": "ji6", "三": "saam1", "声/聲": "sing1", "于/於": "jyu1",
    "高": "gou1", "手": "sau2", "知": "zi1", "理": "lei5",
    "眼": "ngaan5", "志": "zi3", "点/點": "dim2", "心": "sam1",
    "战/戰": "zin3", "二": "ji6", "问/問": "man6", "但": "daan6",
    "身": "san1", "方": "fong1", "实/實": "sat6", "吃": "hek3",
    "做": "zou6", "叫": "giu3", "当/當": "dong1", "住": "zyu6",
    "听/聽": "ting1", "革": "gaak3", "打": "daa2", "呢": "ne1",
    "真": "zan1", "全": "cyun4", "才": "coi4", "四": "sei3",
    "已": "ji5", "所": "so2", "敌/敵": "dik6", "之": "zi1",
    "最": "zeoi3", "光": "gwong1", "产/產": "caan2", "情": "cing4",
    "路": "lou6", "分": "fan1", "总/總": "zung2", "条/條": "tiu4",
    "白": "baak6", "话/話": "waa6", "东/東": "dung1", "席": "zik6",
    "次": "ci3", "亲/親": "can1", "如": "jyu4", "被": "bei6",
    "花": "faa1", "口": "hau2", "放": "fong3", "儿/兒": "ji4",
    "常": "soeng4", "气/氣": "hei3", "五": "ng5", "第": "dai6",
    "使": "si2", "写/寫": "se2", "军/軍": "gwan1", "吧": "baa6",
    "文": "man4", "运/運": "wan6", "再": "zoi3", "果": "gwo2",
    "怎": "zam2", "定": "ding6", "许/許": "heoi2", "快": "faai3",
    "明": "ming4", "行": "hang4", "因": "jan1", "别/別": "bit6",
    "飞/飛": "fei1", "树/樹": "syu6", "物": "mat6", "活": "wut6",
    "部": "bou6", "门/門": "mun4", "无/無": "mou4", "往": "wong5",
    "船": "syun4", "望": "mong6", "新": "san1", "带/帶": "daai3",
    "队/隊": "deoi6", "先": "sin1", "力": "lik6", "完": "jyun4",
    "却/卻": "koek3", "站": "zaam6", "代": "doi6", "员/員": "jyun4",
    "机/機": "gei1", "更": "gang3", "九": "gau2", "您": "nei5",
    "每": "mui5", "风/風": "fung1", "级/級": "kap1", "跟": "gan1",
    "笑": "siu3", "啊": "aa3", "孩": "haai4", "万/萬": "maan6",
    "少": "siu2", "直": "zik6", "意": "ji3", "夜": "je6",
    "比": "bei2", "阶/階": "gaai1", "连/連": "lin4", "车/車": "ce1",
    "重": "cung5", "便": "bin6", "斗/鬥": "dau3", "马/馬": "maa5",
    "哪": "naa5", "化": "faa3", "太": "taai3", "指": "zi2",
    "变/變": "bin3", "社": "se5", "似": "ci5", "士": "si6",
    "者": "ze2", "干/乾": "gon1", "石": "sek6", "满/滿": "mun5",
    "日": "jat6", "决/決": "kyut3", "百": "baak3", "原": "jyun4",
    "拿": "naa4", "群": "kwan4", "究": "gau3", "各": "gok3",
    "六": "luk6", "本": "bun2", "思": "si1", "解": "gaai2",
    "立": "lap6", "河": "ho4", "村": "cyun1", "八": "baat3",
    "难/難": "naan4", "早": "zou2", "论/論": "leon6", "吗/嗎": "maa3",
    "根": "gan1", "共": "gung6", "让/讓": "joeng6", "相": "soeng1",
    "研": "jin4", "今": "gam1", "其": "kei4", "题/題": "tai4",
    "省": "saang2", "与/與": "jyu5", "皮": "pei4", "教": "gaau3",
    "正": "zing3", "笔/筆": "bat1", "七": "cat1", "近": "gan6",
    "信": "seon3", "脸/臉": "lim5", "句": "geoi3", "字": "zi6",
    "间/間": "gaan1", "片": "pin3", "爱/愛": "oi3", "房": "fong4",
    "音": "jam1", "火": "fo2", "介": "gaai3", "觉/覺": "gok3",
    "轻/輕": "hing1", "张/張": "zoeng1", "友": "jau5", "求": "kau4",
    "毛": "mou4", "具": "geoi6", "妈/媽": "maa1", "受": "sau6",
    "挥/揮": "fai1", "名": "ming4", "红/紅": "hung4", "场/場": "coeng4",
    "青": "cing1", "领/領": "ling5", "确/確": "kok3", "传/傳": "cyun4",
    "海": "hoi2", "色": "sik1", "金": "gam1", "接": "zip3",
    "校": "haau6", "元": "jyun4", "肯": "hang2", "练/練": "lin6",
    "远/遠": "jyun5", "钱/錢": "cin4", "吹": "ceoi1", "乐/樂": "lok6",
    "含": "ham4", "坐": "co5", "应/應": "jing1", "低": "dai1",
    "收": "sau1", "财/財": "coi4", "由": "jau4", "达/達": "daat6",
    "冷": "laang5", "哥": "go1", "弟": "dai6", "姐": "ze2",
    "妹": "mui6", "爸": "baa4", "妇/婦": "fu5", "食": "sik6",
    "送": "sung3", "切": "cit3", "星": "sing1", "晚": "maan5",
    "错/錯": "co3", "买/買": "maai5", "卖/賣": "maai6", "午": "ng5",
    "读/讀": "duk6", "书/書": "syu1", "语/語": "jyu5", "词/詞": "ci4",
    "汉/漢": "hon3", "英": "jing1", "法": "faat3", "德": "dak1",
    "美": "mei5", "俄": "ngo4", "服": "fuk6", "衣": "ji1",
    "穿": "cyun1", "鞋": "haai4", "帽": "mou6", "裤/褲": "fu3",
    "杯": "bui1", "茶": "caa4", "酒": "zau2", "饭/飯": "faan6",
    "菜": "coi3", "肉": "juk6", "鱼/魚": "jyu4", "蛋": "daan6",
    "奶": "naai5", "糖": "tong4", "盐/鹽": "jim4", "香": "hoeng1",
    "蕉": "ziu1", "梨": "lei4", "桃": "tou4", "瓜": "gwaa1",
    "米": "mai5", "包": "baau1", "汤/湯": "tong1", "喝": "hot3",
    "渴": "hot3", "饿/餓": "ngo6", "饱/飽": "baau2", "猫/貓": "maau1",
    "狗": "gau2", "鸟/鳥": "niu5", "鸡/雞": "gai1", "猪/豬": "zyu1",
    "羊": "joeng4", "牛": "ngau4", "虎": "fu2", "兔": "tou3",
    "龙/龍": "lung4", "蛇": "se4", "猴": "hau4", "熊": "hung4",
    "象": "zoeng6", "鹿": "luk6", "狼": "long4", "虫/蟲": "cung4",
    "草": "cou2", "叶/葉": "jip6", "林": "lam4", "森": "sam1",
    "种/種": "zung2", "春": "ceon1", "夏": "haa6", "秋": "cau1",
    "冬": "dung1", "季": "gwai3", "节/節": "zit3", "假": "gaa2",
    "雨": "jyu5", "雪": "syut3", "云/雲": "wan4", "雷": "leoi4",
    "电/電": "din6", "冰": "bing1", "热/熱": "jit6", "温/溫": "wan1",
    "凉/涼": "loeng4", "晴": "cing4", "阴/陰": "jam1", "月": "jyut6",
    "空": "hung1", "阳/陽": "joeng4", "田": "tin4", "土": "tou2",
    "岩": "ngaam4", "沙": "saa1", "湖": "wu4", "江": "gong1",
    "池": "ci4", "井": "zing2", "泉": "cyun4", "波": "bo1",
    "浪": "long6", "岛/島": "dou2", "岸": "ngon6", "桥/橋": "kiu4",
    "街": "gaai1", "城": "sing4", "市": "si5", "县/縣": "jyun6",
    "区/區": "keoi1", "镇/鎮": "zan3", "乡/鄉": "hoeng1", "州": "zau1",
    "京": "ging1", "港": "gong2", "台/臺": "toi4", "楼/樓": "lau4",
    "层/層": "cang4", "屋": "uk1", "室": "sat1", "厅/廳": "teng1",
    "窗": "coeng1", "床": "cong4", "桌": "coek3", "椅": "ji2",
    "灯/燈": "dang1", "墙/牆": "coeng4", "院": "jyun2", "园/園": "jyun4",
    "店": "dim3", "馆/館": "gun2", "厂/廠": "cong2", "局": "guk6",
    "医/醫": "ji1", "药/藥": "joek6", "病": "bing6", "痛": "tung3",
    "伤/傷": "soeng1", "治": "zi6", "健": "gin6", "康": "hong1",
    "体/體": "tai2", "脑/腦": "nou5", "耳": "ji5", "鼻": "bei6",
    "嘴": "zeoi2", "牙": "ngaa4", "舌": "sit6", "肩": "gin1",
    "背": "bui3", "胸": "hung1", "肚": "tou5", "腿": "teoi2",
    "脚/腳": "goek3", "血": "hyut3", "骨": "gwat1", "肤/膚": "fu1",
    "汗": "hon6", "泪/淚": "leoi6", "梦/夢": "mung6", "睡": "seoi6",
    "醒": "sing2", "休": "jau1", "息": "sik1", "累": "leoi6",
    "忙": "mong4", "闲/閑/閒": "haan4", "静/靜": "zing6", "闹/鬧": "naau6",
    "吵": "caau2", "安": "on1", "危": "ngai4", "险/險": "him2",
    "保": "bou2", "护/護": "wu6", "救": "gau3", "帮/幫": "bong1",
    "助": "zo6", "谢/謝": "ze6", "请/請": "cing2", "答": "daap3",
    "告": "gou3", "诉/訴": "sou3", "讲/講": "gong2", "谈/談": "taam4",
    "议/議": "ji5", "评/評": "ping4", "批": "pai1", "夸/誇": "kwaa1",
    "骂/罵": "maa6", "哭": "huk1", "喊": "haam3", "唱": "coeng3",
    "歌": "go1", "舞": "mou5", "跳": "tiu3", "跑": "paau2",
    "爬": "paa4", "游": "jau4", "泳": "wing6", "踢": "tek3",
    "球": "kau4", "赛/賽": "coi3", "赢/贏": "jeng4", "输/輸": "syu1",
    "玩": "waan2", "棋": "kei4", "画/畫": "waa2", "图/圖": "tou4",
    "照": "ziu3", "拍": "paak3", "摄/攝": "sip3", "影": "jing2",
    "视/視": "si6", "播": "bo3", "闻/聞": "man4", "报/報": "bou3",
    "纸/紙": "zi2", "刊": "hon1", "版": "baan2", "印": "jan3",
    "刷": "caat3", "剧/劇": "kek6", "戏/戲": "hei3", "演": "jin2",
    "奏": "zau3", "琴": "kam4", "鼓": "gu2", "号/號": "hou6",
    "曲": "kuk1", "调/調": "diu6", "诗/詩": "si1", "史": "si2",
    "古": "gu2", "旧/舊": "gau6", "久": "gau2", "永": "wing5",
    "暂/暫": "zaam6", "短": "dyun2", "延": "jin4", "迟/遲": "ci4",
    "晨": "san4", "昨": "zok6", "周/週": "zau1", "末": "mut6",
    "初": "co1", "终/終": "zung1", "始": "ci2", "段": "dyun6",
    "程": "cing4", "途": "tou4", "旅": "leoi5", "票": "piu3",
    "证/證": "zing3", "卡": "kaa1", "银/銀": "ngan4", "币/幣": "bai6",
    "付": "fu6", "费/費": "fai3", "价/價": "gaa3", "贵/貴": "gwai3",
    "宜": "ji4", "租": "zou1", "借": "ze3", "换/換": "wun6",
    "存": "cyun4", "取": "ceoi2", "递/遞": "dai6", "邮/郵": "jau4",
    "寄": "gei3", "网/網": "mong5", "线/線": "sin3", "码/碼": "maa5",
    "键/鍵": "gin6", "屏": "ping4", "幕": "mok6", "器": "hei3",
    "修": "sau1", "坏/壞": "waai6", "装/裝": "zong1", "卸": "se3",
    "试/試": "si3", "验/驗": "jim6", "查": "caa4", "检/檢": "gim2",
    "测/測": "cak1", "算": "syun3", "计/計": "gai3", "数/數": "sou3",
    "量": "loeng6", "称/稱": "cing1", "秤": "cing3", "尺": "cek3",
    "寸": "cyun3", "克": "hak1", "斤": "gan1", "吨/噸": "deon1",
    "升": "sing1", "加": "gaa1", "减/減": "gaam2", "乘": "sing4",
    "除": "ceoi4", "等": "dang2", "零": "ling4", "半": "bun3",
    "双/雙": "soeng1", "单/單": "daan1", "偶": "ngau5", "奇": "kei4",
    "整": "zing2", "余/餘": "jyu4", "倍": "pui5", "率": "leot6",
    "均": "gwan1", "概": "koi3", "约/約": "joek3", "估": "gu2",
    "准/準": "zeon2", "精": "zing1", "细/細": "sai3", "粗": "cou1",
    "宽/寬": "fun1", "窄": "zaak3", "厚": "hau5", "薄": "bok6",
    "深": "sam1", "浅/淺": "cin2", "矮": "ai2", "瘦": "sau3",
    "壮/壯": "zong3", "弱": "joek6", "强/強": "koeng4", "硬": "ngaang6",
    "软/軟": "jyun5", "紧/緊": "gan2", "松/鬆": "sung1", "密": "mat6",
    "疏": "so1", "虚/虛": "heoi1", "反": "faan2", "丑/醜": "cau2",
    "善": "sin6", "恶/惡": "ok3", "净/淨": "zing6", "脏/髒": "zong1",
    "亮": "loeng6", "暗": "am3", "黑": "hak1", "黄/黃": "wong4",
    "蓝/藍": "laam4", "绿/綠": "luk6", "紫": "zi2", "灰": "fui1",
    "粉": "fan2", "棕": "zung1", "橙": "caang2", "彩": "coi2",
    "颜/顏": "ngaan4", "形": "jing4", "状/狀": "zong6", "圆/圓": "jyun4",
    "角": "gok3", "尖": "zim1", "平": "ping4", "弯/彎": "waan1",
    "斜": "ce4", "横/橫": "waang4", "竖/豎": "syu6", "左": "zo2",
    "右": "jau6", "南": "naam4", "西": "sai1", "北": "bak1",
    "内/內": "noi6", "外": "ngoi6", "旁": "pong4", "邻/鄰": "leon4",
    "隔": "gaak3", "距": "keoi5", "离/離": "lei4", "环/環": "waan4",
    "绕/繞": "jiu5", "围/圍": "wai4", "转/轉": "zyun2", "移": "ji4",
    "挪": "no4", "搬": "bun1", "载/載": "zoi3", "托": "tok3",
    "抬": "toi4", "举/舉": "geoi2", "提": "tai4", "拉": "laai1",
    "推": "teoi1", "拖": "to1", "抱": "pou5", "扛": "kong1",
    "挑": "tiu1", "担/擔": "daam1", "丢/丟": "diu1", "抛/拋": "paau1",
    "捡/撿": "gim2", "拾": "sap6", "抓": "zaau2", "握": "ak1",
    "摸": "mo2", "碰": "pung3", "撞": "zong6", "敲": "haau1",
    "击/擊": "gik1", "踩": "caai2", "踏": "daap6", "登": "dang1",
    "滚/滾": "gwan2", "滑": "waat6", "摔": "seot1", "跌": "dit3",
    "倒": "dou2", "躺": "tong2", "靠": "kaau3", "冲/沖": "cung1",
    "奔": "ban1", "追": "zeoi1", "赶/趕": "gon2", "逃": "tou4",
    "躲": "do2", "藏": "cong4", "寻/尋": "cam4", "找": "zaau2",
    "搜": "sau2", "失": "sat1", "获/獲": "wok6", "留": "lau4",
    "剩": "sing6", "缺": "kyut3", "补/補": "bou2", "添": "tim1",
    "增": "zang1", "消": "siu1", "灭/滅": "mit6", "毁/毀": "wai2",
    "破": "po3", "裂": "lit6", "碎": "seoi3", "断/斷": "dyun6",
    "折": "zit3", "扭": "nau2", "撕": "si1", "剪": "zin2",
    "割": "got3", "砍": "ham2", "锯/鋸": "geoi3", "钻/鑽": "zyun3",
    "挖": "waat3", "埋": "maai4", "填": "tin4", "盖/蓋": "goi3",
    "遮": "ze1", "裹": "gwo2", "捆": "kwan2", "绑/綁": "bong2",
    "系/係": "hai6", "关/關": "gwaan1", "锁/鎖": "so2", "封": "fung1",
    "贴/貼": "tip3", "挂/掛": "gwaa3", "吊": "diu3", "钉/釘": "ding1",
    "插": "caap3", "拔": "bat6", "塞": "sak1", "灌": "gun3",
    "洒/灑": "saa2", "泼/潑": "put3", "滴": "dik1", "流": "lau4",
    "渗/滲": "sam3", "漏": "lau6", "涨/漲": "zoeng3", "退": "teoi3",
    "淹": "jim1", "浮": "fau4", "沉": "cam4", "漂": "piu1",
    "洗": "sai2", "擦": "caat3", "抹": "maat3", "扫/掃": "sou3",
    "晒/曬": "saai3", "烤": "haau1", "烧/燒": "siu1", "煮": "zyu2",
    "蒸": "zing1", "炒": "caau2", "炸": "zaa3", "煎": "zin1",
    "炖/燉": "dan6", "拌": "bun6", "剥/剝": "mok1", "削": "soek3",
    "磨": "mo4", "压/壓": "aat3", "榨": "zaa3", "挤/擠": "zai1",
    "泡": "paau3", "腌/醃": "jip3", "冻/凍": "dung3", "融": "jung4",
    "凝": "jing4", "固": "gu3", "液": "jik6", "汽": "hei3",
    "烟/煙": "jin1", "雾/霧": "mou6", "尘/塵": "can4", "油": "jau4",
    "脂": "zi1", "蜡/蠟": "laap6", "胶/膠": "gaau1", "漆": "cat1",
    "墨": "mak6", "铁/鐵": "tit3", "钢/鋼": "gong3", "铜/銅": "tung4",
    "铝/鋁": "leoi5", "锡/錫": "sek3", "铅/鉛": "jyun4", "矿/礦": "kwong3",
    "煤": "mui4", "炭": "taan3", "玻": "bo1", "璃": "lei4",
    "瓷": "ci4", "陶": "tou4", "砖/磚": "zyun1", "瓦": "ngaa5",
    "泥": "nai4", "塑": "sou3", "料": "liu6", "棉": "min4",
    "麻": "maa4", "丝/絲": "si1", "绸/綢": "cau4", "布": "bou3",
    "绒/絨": "jung4", "绳/繩": "sing4", "圈": "hyun1", "袋": "doi6",
    "箱": "soeng1", "盒": "hap6", "桶": "tung2", "罐": "gun3",
    "瓶": "ping4", "壶/壺": "wu4", "碗": "wun2", "盘/盤": "pun4",
    "碟": "dip6", "筷": "faai3", "叉": "caa1", "刀": "dou1",
    "锅/鍋": "wo1", "炉/爐": "lou4", "灶/竈": "zou3", "柜/櫃": "gwai6",
    "架": "gaa3", "篮/籃": "laam4", "梯": "tai1", "凳": "dang3",
    "镜/鏡": "ging3", "梳": "so1", "巾": "gan1", "伞/傘": "saan3",
    "扇": "sin3", "钟/鐘": "zung1", "表/錶": "biu2", "针/針": "zam1",
    "夹/夾": "gaap3", "订/訂": "ding3", "册/冊": "caak3", "页/頁": "jip6",
    "章": "zoeng1", "篇": "pin1", "母": "mou5", "拼": "ping3",
    "念": "nim6", "默": "mak6", "抄": "caau1", "译/譯": "jik6",
    "注": "zyu3", "释/釋": "sik1", "培": "pui4", "训/訓": "fan3",
    "考": "haau2", "卷": "gyun2", "案": "on3", "析": "sik1",
    "探": "taam3", "索": "sok3", "创/創": "cong3", "造": "zou6",
    "设/設": "cit3", "制/製": "zai3", "建": "gin3", "筑/築": "zuk1",
    "公": "gung1", "散": "saan3", "步": "bou6", "历/歷": "lik6",
    "欢/歡": "fun1", "迎": "jing4", "习/習": "zaap6", "记/記": "gei3",
    "忆/憶": "jik1", "忘": "mong4", "感": "gam2", "恩": "jan1",
    "愿/願": "jyun6", "希": "hei1", "盼": "paan3", "期": "kei4",
    "待": "doi6", "预/預": "jyu6", "或": "waak6", "若": "joek6",
    "虽/雖": "seoi1", "且": "ce2", "并/並": "bing6", "则/則": "zak1",
    "即": "zik1", "既": "gei3", "必": "bit1", "须/須": "seoi1",
    "需": "seoi1", "能": "nang4", "该/該": "goi1", "敢": "gam2",
    "懂": "dung2", "识/識": "sik1", "智": "zi3", "慧": "wai6",
    "聪/聰": "cung1", "谁/誰": "seoi4", "某": "mau5", "任": "jam6",
    "凡": "faan4", "另": "ling6", "彼": "bei2", "此": "ci2",
    "互": "wu6", "术/術": "seot6", "科": "fo1", "察": "caat3",
    "观/觀": "gun1", "览/覽": "laam5", "显/顯": "hin2", "示": "si6",
    "述": "seot6", "描": "miu4", "绘/繪": "kui2", "录/錄": "luk6",
    "编/編": "pin1", "排": "paai4", "列": "lit6", "序": "zeoi6",
    "组/組": "zou2", "织/織": "zik1", "构/構": "kau3", "统/統": "tung2",
    "规/規": "kwai1", "律": "leot6", "例": "lai6", "式": "sik1",
    "型": "jing4", "类/類": "leoi6", "款": "fun2", "项/項": "hong6",
    "务/務": "mou6", "责/責": "zaak3", "职/職": "zik1", "权/權": "kyun4",
    "利": "lei6", "益": "jik1", "损/損": "syun2", "害": "hoi6",
    "罚/罰": "fat6", "奖/獎": "zoeng2", "赏/賞": "soeng2", "励/勵": "lai6",
    "努": "nou5", "勤": "kan4", "懒/懶": "laan5", "勇": "jung5",
    "怕": "paa3", "惊/驚": "ging1", "恐": "hung2", "慌": "fong1",
    "忧/憂": "jau1", "愁": "sau4", "烦/煩": "faan4", "怒": "nou6",
    "恨": "han6", "怨": "jyun3", "悔": "fui3", "惜": "sik1",
    "怜/憐": "lin4", "慕": "mou6", "羡/羨": "sin6", "骄/驕": "giu1",
    "傲": "ngou6", "谦/謙": "him1", "诚/誠": "sing4", "谎/謊": "fong1",
    "骗/騙": "pin3", "偷": "tau1", "抢/搶": "coeng2", "盗/盜": "dou6",
    "罪": "zeoi6", "犯": "faan6", "警": "ging2", "捕": "bou6",
    "审/審": "sam2", "判": "pun3", "狱/獄": "juk6", "政": "zing3",
    "府": "fu2", "党/黨": "dong2", "委": "wai2", "官": "gun1",
    "选/選": "syun2", "投": "tau4", "税/稅": "seoi3", "贸/貿": "mau6",
    "易": "ji6", "购/購": "kau3", "销/銷": "siu1", "售": "sau6",
    "货/貨": "fo3", "商": "soeng1", "业/業": "jip6", "企": "kei5",
    "司": "si1", "营/營": "jing4", "管": "gun2", "雇/僱": "gu3",
    "聘": "ping3", "薪": "san1", "酬": "cau4", "富": "fu3",
    "穷/窮": "kung4", "贫/貧": "pan4", "债/債": "zaai3", "赚/賺": "zaan6",
    "赔/賠": "pui4", "亏/虧": "kwai1", "盈": "jing4", "婚": "fan1",
    "嫁": "gaa3", "娶": "ceoi2", "妻": "cai1", "夫": "fu1",
    "女": "neoi5", "孙/孫": "syun1", "祖": "zou2", "宗": "zung1",
    "族": "zuk6", "戚": "cik1", "居": "geoi1", "客": "haak3",
    "宾/賓": "ban1", "仆/僕": "buk6", "宣": "syun1", "济/濟": "zai3",
    "策": "caak3", "效": "haau6", "境": "ging2", "况/況": "fong3",
    "态/態": "taai3", "势/勢": "sai3", "景": "ging2", "征": "zing1",
    "兆": "siu6", "亿/億": "jik1", "兼": "gim1", "较/較": "gaau3",
    "超": "ciu1", "越": "jyut6", "限": "haan6", "止": "zi2",
    "禁": "gam3", "允": "wan5", "据/據": "geoi3", "依": "ji1",
    "按": "on3", "粤/粵": "jyut6", "广/廣": "gwong2", "唔": "m4",
    "嘅": "ge3", "咗": "zo2", "喺": "hai2", "佢": "keoi5",
    "哋": "dei6", "冇": "mou5", "咁": "gam3", "嗰": "go2",
    "乜": "mat1", "睇": "tai2", "畀": "bei2", "俾": "bei2",
    "嚟": "lai4", "攞": "lo2", "靓/靚": "leng3", "瞓": "fan3",
    "饮/飲": "jam2", "落": "lok6", "返": "faan1", "企": "kei5",
    "苹/蘋": "ping4", "犀": "sai1", "鍾": "zung1",
}

JYUTPING: dict[str, str] = {}
for _ks, _v in _CHARS_SRC.items():
    for _k in _ks.split("/"):
        JYUTPING[_k] = _v

_HAN_RE = re.compile(r"[㐀-鿿豈-﫿]")
_warned_hanzi: set[str] = set()


def _is_hanzi(ch: str) -> bool:
    return bool(_HAN_RE.match(ch))


_LEX_BY_FIRST: dict[str, list[str]] = {}
for _w in sorted(WORDS, key=len, reverse=True):
    _LEX_BY_FIRST.setdefault(_w[0], []).append(_w)


def _read_number_at(text: str, i: int) -> tuple[str, int] | None:
    m = re.match(r"\d+", text[i:])
    if not m:
        return None
    digits = m.group(0)
    j = i + len(digits)
    for mw, mjp in _MEASURES.items():
        if len(mw) > 1 and text.startswith(mw, j):
            return number_to_jyutping(int(digits), loeng=True) + " " + mjp, j + len(mw)
    nxt = text[j] if j < len(text) else ""
    if nxt in _MEASURES and len(nxt) == 1:
        return (
            number_to_jyutping(int(digits), loeng=(nxt not in "年月日号號"))
            + " " + _MEASURES[nxt],
            j + 1,
        )
    return number_to_jyutping(int(digits)), j


_PUNCT = {"。": ".", "．": ".", "，": ",", "、": ",", "！": "!",
          "？": "?", "：": ":", "；": ";", "「": '"', "」": '"',
          "『": '"', "』": '"', "（": "(", "）": ")", "《": '"',
          "》": '"', "　": " "}


def read_cantonese(text: str) -> str:
    """hanzi/numeral text → toned jyutping string (space-separated,
    trailing tone digits 1-6).

    Same Viterbi lattice design as conditioning/zh.py::read_chinese
    (WORDS beat per-char readings via length-discounted cost); chars
    missing from the Cantonese tables fall back to the toneless Mandarin
    reading, then drop, each with one loud warning per character.
    """
    from zonos_tpu_torch.conditioning import zh

    n = len(text)
    COST_WORD_BASE = 9.0
    COST_CHAR = 6.0
    COST_NUM = 3.0
    COST_OTHER = 2.0
    COST_MANDARIN = 40.0
    COST_DROP = 100.0

    INF = float("inf")
    best = [INF] * (n + 1)
    back: list[tuple[int, str, str] | None] = [None] * (n + 1)
    best[0] = 0.0
    for i in range(n):
        if best[i] == INF:
            continue
        ch = text[i]
        num = _read_number_at(text, i)
        if num is not None:
            reading, j = num
            c = best[i] + COST_NUM
            if c < best[j]:
                best[j], back[j] = c, (i, reading, "num")
        for w in _LEX_BY_FIRST.get(ch, ()):
            if text.startswith(w, i):
                j = i + len(w)
                c = best[i] + max(COST_WORD_BASE - 2.0 * len(w), 1.0)
                if c < best[j]:
                    best[j], back[j] = c, (i, WORDS[w], "word")
        if _is_hanzi(ch):
            jp = JYUTPING.get(ch)
            if jp is not None:
                c = best[i] + COST_CHAR
                if c < best[i + 1]:
                    best[i + 1], back[i + 1] = c, (i, jp, "char")
            else:
                py = zh.PINYIN.get(ch)
                if py is not None:
                    c = best[i] + COST_MANDARIN
                    if c < best[i + 1]:
                        # Strip the Mandarin tone digit: claiming a Mandarin
                        # tone contour in a Cantonese stream would be wrong.
                        best[i + 1], back[i + 1] = c, (i, py.rstrip("12345"), "mandarin")
            c = best[i] + COST_DROP
            if c < best[i + 1]:
                best[i + 1], back[i + 1] = c, (i, "", "drop")
        else:
            c = best[i] + COST_OTHER
            if c < best[i + 1]:
                best[i + 1], back[i + 1] = c, (i, _PUNCT.get(ch, ch), "other")

    pieces: list[tuple[str, str, str]] = []
    j = n
    while j > 0:
        prev, reading, kind = back[j]  # type: ignore[misc]
        pieces.append((reading, kind, text[prev:j]))
        j = prev
    pieces.reverse()

    out: list[str] = []
    for reading, kind, surface in pieces:
        if kind == "drop":
            if surface not in _warned_hanzi:
                _warned_hanzi.add(surface)
                logger.warning(
                    "Cantonese fallback: no reading for hanzi %r — dropped "
                    "(install espeak-ng for full coverage)", surface,
                )
            continue
        if kind == "mandarin" and surface not in _warned_hanzi:
            _warned_hanzi.add(surface)
            logger.warning(
                "Cantonese fallback: %r missing from the jyutping lexicon — "
                "using its toneless MANDARIN reading", surface,
            )
        if kind in ("word", "char", "num", "mandarin"):
            if out and out[-1] and not out[-1].endswith(" "):
                out.append(" ")
            out.append(reading)
        else:
            out.append(reading)
    return "".join(out).strip()


def cantonese_to_ipa(text: str) -> str:
    """hanzi text → IPA via jyutping, tones as Chao letters (espeak style).

    Mandarin-fallback segments (toneless pinyin) are converted with the
    Mandarin pinyin→IPA map so e.g. an untabled char still sounds out.
    """
    from zonos_tpu_torch.conditioning.zh import pinyin_to_ipa

    jp = read_cantonese(text)
    out: list[str] = []
    for token in re.split(r"(\s+|[;:,.!?()\"-])", jp):
        if not token:
            continue
        if re.fullmatch(r"[a-z]+[1-6]", token):
            out.append(jyutping_to_ipa(token))
        elif re.fullmatch(r"[a-zv]+", token):
            out.append(pinyin_to_ipa(token))
        else:
            out.append(" " if token.isspace() else token)
    return "".join(out)


def coverage(text: str) -> float:
    """Fraction of hanzi receiving a Cantonese (not Mandarin) reading."""
    total = sum(1 for ch in text if _is_hanzi(ch))
    if total == 0:
        return 1.0
    covered = sum(
        1 for ch in text if _is_hanzi(ch)
        and (ch in JYUTPING or any(ch in w for w in WORDS))
    )
    return covered / total
