"""Dictionary-free Mandarin reading fallback: hanzi → pinyin → IPA.

The reference resolves Chinese ("cmn"/"yue") through eSpeak NG
(the reference's zonos/conditioning.py:291-335, language list :525-536, 109 codes),
which ships a full hanzi dictionary. Without espeak, hanzi would previously
degrade to the grapheme tier — and the model's symbol table has no CJK
characters, so every one became UNK (total loss). This module raises
Mandarin to intelligible the same way ``conditioning/ja.py`` does Japanese:

* an embedded frequency-ranked hanzi → pinyin table (~1550 characters,
  covering ≈98% of running text) plus a word lexicon for the common
  polyphonic characters (的/得/地, 行 xíng/háng, 长 cháng/zhǎng,
  重 zhòng/chóng, 乐 lè/yuè, 都 dōu/dū, …) disambiguated by Viterbi
  segmentation exactly as in ja.py;
* an exact Arabic-numeral reader (一 through 万亿 scale, 两-selection
  before measure words);
* a regular pinyin → IPA mapping (Standard Mandarin initials/finals).
  TONES ARE EMITTED as Chao letters after each syllable (1 ˥, 2 ˧˥,
  3 ˨˩˦, 4 ˥˩, neutral unmarked) — the same convention eSpeak NG's IPA
  output uses, which is what the reference pipeline feeds the tokenizer.
  The model's phoneme table has no tone letters, so they map to the UNK id
  exactly as in the reference (conditioning.py:240-241
  ``_symbol_to_id.get(s, 1)``): the checkpoint saw a tone-dependent UNK run
  after every syllable, and omitting it would shift the token-stream shape.
  Standard tone sandhi is applied on the pinyin stream (3-3 → 2-3,
  不 bù→bú before tone 4, quantifier 一 yī→yí/yì by following tone).

Cantonese ("yue") has its own engine (conditioning/yue.py, jyutping-based);
espeak.py routes it there. Calling ``read_chinese`` with a yue language tag
directly still works — Mandarin readings with a loud one-time warning.
"""

from __future__ import annotations

import logging
import re

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Pinyin → IPA (Standard Mandarin; tones dropped)
# ---------------------------------------------------------------------------

_INITIALS = [
    ("zh", "ʈʂ"), ("ch", "ʈʂʰ"), ("sh", "ʂ"),
    ("b", "p"), ("p", "pʰ"), ("m", "m"), ("f", "f"),
    ("d", "t"), ("t", "tʰ"), ("n", "n"), ("l", "l"),
    ("g", "k"), ("k", "kʰ"), ("h", "x"),
    ("j", "tɕ"), ("q", "tɕʰ"), ("x", "ɕ"),
    ("r", "ʐ"), ("z", "ts"), ("c", "tsʰ"), ("s", "s"),
]

# Finals, longest first. ü is written v in the embedded tables.
_FINALS = [
    ("iang", "jaŋ"), ("iong", "jʊŋ"), ("uang", "waŋ"), ("ueng", "wəŋ"),
    ("ian", "jɛn"), ("iao", "jaw"), ("ang", "aŋ"), ("eng", "əŋ"),
    ("ong", "ʊŋ"), ("uai", "waj"), ("uan", "wan"), ("van", "ɥɛn"),
    ("ai", "aj"), ("ao", "aw"), ("an", "an"), ("ei", "ej"), ("en", "ən"),
    ("er", "ɚ"), ("ia", "ja"), ("ie", "jɛ"), ("in", "in"), ("ing", "iŋ"),
    ("iu", "jow"), ("ou", "ow"), ("ua", "wa"), ("uo", "wo"), ("ui", "wej"),
    ("un", "wən"), ("ue", "ɥɛ"), ("ve", "ɥɛ"), ("vn", "yn"),
    ("uen", "wən"), ("iou", "jow"), ("uei", "wej"), ("uin", "win"),
    ("a", "a"), ("e", "ɤ"), ("i", "i"), ("o", "o"), ("u", "u"), ("v", "y"),
]

# i after sibilants is the apical vowel, not /i/.
_APICAL = {"z", "c", "s", "zh", "ch", "sh", "r"}

# Chao tone letters appended after each syllable (espeak IPA convention;
# index = tone digit, 5/0 = neutral, unmarked).
_TONE_IPA = {"1": "˥", "2": "˧˥", "3": "˨˩˦", "4": "˥˩", "5": ""}


def pinyin_to_ipa(syllable: str) -> str:
    """One pinyin syllable (optional trailing tone digit 1-5) → IPA
    ('' for empty/unknown)."""
    s = syllable.strip().lower()
    tone = ""
    if s and s[-1] in _TONE_IPA:
        tone = _TONE_IPA[s[-1]]
        s = s[:-1]
    if not s:
        return ""
    # y/w onsets are orthographic forms of i/u finals.
    if s.startswith("yu"):
        s = "v" + s[2:]
    elif s.startswith("yi"):
        s = "i" + s[2:]
    elif s.startswith("y"):
        s = "i" + s[1:]
    if s.startswith("wu"):
        s = "u" + s[2:]
    elif s.startswith("w"):
        s = "u" + s[1:]

    initial, ipa_init = "", ""
    for pin, ipa in _INITIALS:
        if s.startswith(pin):
            initial, ipa_init = pin, ipa
            s = s[len(pin):]
            break

    if s == "i" and initial in _APICAL:
        return ipa_init + "ɨ" + tone
    # ju/qu/xu spell ü.
    if initial in ("j", "q", "x") and s.startswith("u"):
        s = "v" + s[1:]
    # Bare finals starting with i/u after no initial → glide onset.
    for pin, ipa in _FINALS:
        if s == pin:
            # A final-initial i/u with no onset consonant becomes a glide+vowel;
            # the _FINALS values already encode medials (j/w), so only the bare
            # "i"/"u"/"v" nucleus needs nothing extra.
            return ipa_init + ipa + tone
    # Unknown tail: emit what we can, vowel-letter by letter.
    plain = {"a": "a", "e": "ɤ", "i": "i", "o": "o", "u": "u", "v": "y", "n": "n", "g": "ŋ", "r": "ɚ"}
    return ipa_init + "".join(plain.get(c, "") for c in s) + tone


# ---------------------------------------------------------------------------
# Numbers
# ---------------------------------------------------------------------------

_DIGIT_PY = ["ling2", "yi1", "er4", "san1", "si4", "wu3", "liu4", "qi1", "ba1", "jiu3"]


def number_to_pinyin(n: int, *, liang: bool = False) -> str:
    """Non-negative integer → space-separated toned pinyin."""
    if n == 0:
        return "ling2"
    if n >= 10**12:
        return " ".join(_DIGIT_PY[int(c)] for c in str(n))

    def four(k: int, leading_unit: bool) -> list[str]:
        # 0 < k < 10000 → pinyin parts; leading_unit: 10-19 read "shi ..".
        out: list[str] = []
        th, k2 = divmod(k, 1000)
        h, k3 = divmod(k2, 100)
        t, d = divmod(k3, 10)
        if th:
            out += [_DIGIT_PY[th], "qian1"]
            if not h and (t or d):
                out.append("ling2")
        if h:
            out += [_DIGIT_PY[h], "bai3"]
            if not t and d:
                out.append("ling2")
        if t:
            if t == 1 and not th and not h and leading_unit:
                out.append("shi2")
            else:
                out += [_DIGIT_PY[t], "shi2"]
        if d:
            out.append(_DIGIT_PY[d])
        return out

    groups: list[int] = []
    while n:
        n, g = divmod(n, 10000)
        groups.append(g)
    units = ["", "wan4", "yi4"]
    parts: list[str] = []
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if not g:
            continue
        seg = four(g, leading_unit=(i == len(groups) - 1))
        if units[i]:
            seg.append(units[i])
        parts += seg
    if liang and parts == ["er4"]:
        parts = ["liang3"]
    return " ".join(parts)


# Measure words that prefer 两 for 2 and are common after numerals.
_MEASURES = {"个": "ge4", "本": "ben3", "只": "zhi1", "条": "tiao2", "张": "zhang1",
             "件": "jian4", "位": "wei4", "名": "ming2", "台": "tai2", "辆": "liang4",
             "杯": "bei1", "瓶": "ping2", "块": "kuai4", "元": "yuan2", "岁": "sui4",
             "年": "nian2", "月": "yue4", "日": "ri4", "号": "hao4", "天": "tian1",
             "次": "ci4", "遍": "bian4", "种": "zhong3", "点": "dian3", "分": "fen1",
             "秒": "miao3", "小时": "xiao3 shi2", "分钟": "fen1 zhong1"}


# ---------------------------------------------------------------------------
# Word lexicon (polyphonic-character disambiguation + high-frequency words)
# ---------------------------------------------------------------------------
# Values are space-separated toned pinyin (trailing digit 1-5; 5 = neutral).
# Single-char defaults live in
# PINYIN below; entries here override them in context via the Viterbi cost.

WORDS: dict[str, str] = {
    # 的/地/得 — de as particles (default 的 de already), 得 dei in 得去
    "目的": "mu4 di4", "的确": "di2 que4", "打的": "da3 di1",
    "土地": "tu3 di4", "地方": "di4 fang1", "地球": "di4 qiu2", "地图": "di4 tu2",
    "地铁": "di4 tie3", "地址": "di4 zhi3", "地区": "di4 qu1", "地面": "di4 mian4",
    "获得": "huo4 de2", "觉得": "jue2 de5", "记得": "ji4 de5", "值得": "zhi2 de5",
    "得到": "de2 dao4",
    # 行 xing/hang
    "银行": "yin2 hang2", "行业": "hang2 ye4", "一行": "yi4 hang2", "行列": "hang2 lie4",
    "自行车": "zi4 xing2 che1", "旅行": "lv3 xing2", "行为": "xing2 wei2",
    "进行": "jin4 xing2", "流行": "liu2 xing2", "行动": "xing2 dong4",
    # 长 chang/zhang
    "长大": "zhang3 da4", "校长": "xiao4 zhang3", "长辈": "zhang3 bei4",
    "成长": "cheng2 zhang3", "队长": "dui4 zhang3", "市长": "shi4 zhang3",
    "长城": "chang2 cheng2", "长江": "chang2 jiang1", "长期": "chang2 qi1",
    "很长": "hen3 chang2", "长度": "chang2 du4",
    # 重 zhong/chong
    "重要": "zhong4 yao4", "重量": "zhong4 liang4", "严重": "yan2 zhong4",
    "重复": "chong2 fu4", "重新": "chong2 xin1",
    # 乐 le/yue
    "音乐": "yin1 yue4", "乐器": "yue4 qi4", "快乐": "kuai4 le4", "乐观": "le4 guan1",
    # 都 dou/du
    "首都": "shou3 du1", "都市": "du1 shi4", "成都": "cheng2 du1",
    # 会 hui (kuai in 会计)
    "会计": "kuai4 ji4",
    # 发 fa1/fa4, 头发 fa4
    "头发": "tou2 fa4", "发现": "fa1 xian4", "发展": "fa1 zhan3",
    # 还 hai/huan
    "还有": "hai2 you3", "还是": "hai2 shi4", "还钱": "huan2 qian2",
    "归还": "gui1 huan2",
    # 着 zhe/zhao/zhuo
    "着急": "zhao2 ji2", "穿着": "chuan1 zhe5", "睡着": "shui4 zhao2",
    # 觉 jue/jiao
    "睡觉": "shui4 jiao4", "感觉": "gan3 jue2", "觉得": "jue2 de5",
    # 教 jiao/jiao4
    "教育": "jiao4 yu4", "教师": "jiao4 shi1", "教室": "jiao4 shi4", "教学": "jiao4 xue2",
    # 为 wei/wei4
    "因为": "yin1 wei4", "为了": "wei4 le5", "为什么": "wei4 shen2 me5",
    "认为": "ren4 wei2", "成为": "cheng2 wei2", "行为": "xing2 wei2",
    # 好 hao/hao4
    "爱好": "ai4 hao4", "好奇": "hao4 qi2",
    # 少 shao/shao4
    "少年": "shao4 nian2", "多少": "duo1 shao3", "减少": "jian3 shao3",
    # 几 ji/ji3
    "几乎": "ji1 hu1", "茶几": "cha2 ji1",
    # 干 gan/gan4
    "干净": "gan1 jing4", "干部": "gan4 bu4", "干活": "gan4 huo2", "饼干": "bing3 gan1",
    # 空 kong/kong4
    "天空": "tian1 kong1", "空气": "kong1 qi4", "空闲": "kong4 xian2", "有空": "you3 kong4",
    # 便 bian/pian
    "方便": "fang1 bian4", "便宜": "pian2 yi5", "顺便": "shun4 bian4",
    # 参 can/shen
    "参加": "can1 jia1", "参观": "can1 guan1", "人参": "ren2 shen1",
    # 差 cha/chai
    "差不多": "cha4 bu5 duo1", "出差": "chu1 chai1", "差别": "cha1 bie2",
    # 假 jia/jia4
    "假期": "jia4 qi1", "放假": "fang4 jia4", "假如": "jia3 ru2",
    # 间 jian/jian4
    "时间": "shi2 jian1", "房间": "fang2 jian1", "中间": "zhong1 jian1",
    # 应 ying/ying4
    "应该": "ying1 gai1", "应用": "ying4 yong4",
    # 相 xiang/xiang4
    "相信": "xiang1 xin4", "互相": "hu4 xiang1", "照相": "zhao4 xiang4",
    # 转 zhuan/zhuan4
    "转变": "zhuan3 bian4", "旋转": "xuan2 zhuan3",
    # 藏 cang/zang
    "西藏": "xi1 zang4", "躲藏": "duo3 cang2",
    # 弹 dan/tan
    "子弹": "zi3 dan4", "弹琴": "tan2 qin2",
    # 调 diao/tiao
    "调查": "diao4 cha2", "调整": "tiao2 zheng3", "空调": "kong1 tiao2",
    # 数 shu/shu3
    "数学": "shu4 xue2", "数字": "shu4 zi4", "数量": "shu4 liang4",
    # 切 qie/qie4
    "一切": "yi2 qie4", "亲切": "qin1 qie4",
    # 更 geng/geng4
    "更加": "geng4 jia1", "更好": "geng4 hao3", "更新": "geng1 xin1",
    # 传 chuan/zhuan
    "传统": "chuan2 tong3", "传说": "chuan2 shuo1", "自传": "zi4 zhuan4",
    # 模 mo/mu
    "模型": "mo2 xing2", "模样": "mu2 yang4",
    # 薄 bao/bo
    "薄弱": "bo2 ruo4",
    # 血 xue/xie
    "血液": "xue4 ye4", "流血": "liu2 xie3",
    # high-frequency multi-char function words (cheap Viterbi wins)
    "我们": "wo3 men5", "你们": "ni3 men5", "他们": "ta1 men5", "她们": "ta1 men5",
    "什么": "shen2 me5", "怎么": "zen3 me5", "这么": "zhe4 me5", "那么": "na4 me5",
    "没有": "mei2 you3", "可以": "ke3 yi3", "知道": "zhi1 dao4", "现在": "xian4 zai4",
    "今天": "jin1 tian1", "明天": "ming2 tian1", "昨天": "zuo2 tian1",
    "中国": "zhong1 guo2", "中文": "zhong1 wen2", "普通话": "pu3 tong1 hua4",
    "北京": "bei3 jing1", "上海": "shang4 hai3", "谢谢": "xie4 xie5",
    "朋友": "peng2 you3", "老师": "lao3 shi1", "学生": "xue2 sheng1",
    "学习": "xue2 xi2", "工作": "gong1 zuo4", "时候": "shi2 hou4",
    "喜欢": "xi3 huan1", "非常": "fei1 chang2", "已经": "yi3 jing1",
    "电脑": "dian4 nao3", "电话": "dian4 hua4", "电影": "dian4 ying3",
    "汉语": "han4 yu3", "英语": "ying1 yu3", "世界": "shi4 jie4",
    "大家": "da4 jia1", "东西": "dong1 xi5", "先生": "xian1 sheng5",
    "小姐": "xiao3 jie3", "孩子": "hai2 zi5", "早上": "zao3 shang5",
    "晚上": "wan3 shang5", "中午": "zhong1 wu3", "再见": "zai4 jian4",
    "出租车": "chu1 zu1 che1", "飞机": "fei1 ji1", "火车": "huo3 che1",
    "自己": "zi4 ji3", "问题": "wen4 ti2", "开始": "kai1 shi3",
    "认识": "ren4 shi5", "高兴": "gao1 xing4", "漂亮": "piao4 liang5",
    "便利店": "bian4 li4 dian4",
    # polyphone batch 3
    "了解": "liao3 jie3", "了不起": "liao3 bu5 qi3", "受不了": "shou4 bu5 liao3",
    "行李": "xing2 li5", "地道": "di4 dao5", "斗争": "dou4 zheng1",
    "北斗": "bei3 dou3", "冠军": "guan4 jun1", "干燥": "gan1 zao4",
    "树干": "shu4 gan4", "松散": "song1 san3", "散文": "san3 wen2",
    "曾经": "ceng2 jing1", "还书": "huan2 shu1", "还款": "huan2 kuan3",
    "率领": "shuai4 ling3", "效率": "xiao4 lv4", "的士": "di1 shi4",
    "切换": "qie1 huan4", "朝鲜": "chao2 xian3", "重庆": "chong2 qing4",
    "朝代": "chao2 dai4", "上朝": "shang4 chao2", "处理": "chu3 li3",
    "处于": "chu3 yu2", "到处": "dao4 chu4", "好处": "hao3 chu4",
    "难处": "nan2 chu4", "为难": "wei2 nan2", "灾难": "zai1 nan4",
    "难民": "nan4 min2", "磨坊": "mo4 fang2", "石磨": "shi2 mo4",
    "答应": "da1 ying5", "反应": "fan3 ying4", "应用": "ying4 yong4",
    "空儿": "kong4 er5", "更正": "geng1 zheng4", "半夜三更": "ban4 ye4 san1 geng1",
    # erhua: 儿 is a neutral -r suffix in these, not the full syllable er2
    "这儿": "zhe4 er5", "那儿": "na4 er5", "哪儿": "na3 er5",
    "一点儿": "yi4 dian3 er5", "有点儿": "you3 dian3 er5",
    "一会儿": "yi2 hui4 er5", "一块儿": "yi2 kuai4 er5",
    "事儿": "shi4 er5", "玩儿": "wan2 er5",
}

# ---------------------------------------------------------------------------
# Single-character pinyin (frequency-ranked core, toned; v = ü)
# ---------------------------------------------------------------------------

PINYIN: dict[str, str] = {
    "的": "de5", "一": "yi1", "是": "shi4", "了": "le5", "我": "wo3", "不": "bu4",
    "在": "zai4", "人": "ren2", "们": "men5", "有": "you3", "来": "lai2",
    "他": "ta1", "这": "zhe4", "上": "shang4", "着": "zhe5", "个": "ge4",
    "地": "de5", "到": "dao4", "大": "da4", "里": "li3", "说": "shuo1",
    "就": "jiu4", "去": "qu4", "子": "zi5", "得": "de5", "也": "ye3", "和": "he2",
    "那": "na4", "要": "yao4", "下": "xia4", "看": "kan4", "天": "tian1",
    "时": "shi2", "过": "guo4", "出": "chu1", "小": "xiao3", "么": "me5",
    "起": "qi3", "你": "ni3", "都": "dou1", "把": "ba3", "好": "hao3",
    "还": "hai2", "多": "duo1", "没": "mei2", "为": "wei4", "又": "you4",
    "可": "ke3", "家": "jia1", "学": "xue2", "只": "zhi3", "以": "yi3",
    "主": "zhu3", "会": "hui4", "样": "yang4", "年": "nian2", "想": "xiang3",
    "生": "sheng1", "同": "tong2", "老": "lao3", "中": "zhong1", "十": "shi2",
    "从": "cong2", "自": "zi4", "面": "mian4", "前": "qian2", "头": "tou2",
    "道": "dao4", "它": "ta1", "后": "hou4", "然": "ran2", "走": "zou3",
    "很": "hen3", "像": "xiang4", "见": "jian4", "两": "liang3", "用": "yong4",
    "她": "ta1", "国": "guo2", "动": "dong4", "进": "jin4", "成": "cheng2",
    "回": "hui2", "什": "shen2", "边": "bian1", "作": "zuo4", "对": "dui4",
    "开": "kai1", "而": "er2", "己": "ji3", "些": "xie1", "现": "xian4",
    "山": "shan1", "民": "min2", "候": "hou4", "经": "jing1", "发": "fa1",
    "工": "gong1", "向": "xiang4", "事": "shi4", "命": "ming4", "给": "gei3",
    "长": "chang2", "水": "shui3", "几": "ji3", "义": "yi4", "三": "san1",
    "声": "sheng1", "于": "yu2", "高": "gao1", "手": "shou3", "知": "zhi1",
    "理": "li3", "眼": "yan3", "志": "zhi4", "点": "dian3", "心": "xin1",
    "战": "zhan4", "二": "er4", "问": "wen4", "但": "dan4", "身": "shen1",
    "方": "fang1", "实": "shi2", "吃": "chi1", "做": "zuo4", "叫": "jiao4",
    "当": "dang1", "住": "zhu4", "听": "ting1", "革": "ge2", "打": "da3",
    "呢": "ne5", "真": "zhen1", "全": "quan2", "才": "cai2", "四": "si4",
    "已": "yi3", "所": "suo3", "敌": "di2", "之": "zhi1", "最": "zui4",
    "光": "guang1", "产": "chan3", "情": "qing2", "路": "lu4", "分": "fen1",
    "总": "zong3", "条": "tiao2", "白": "bai2", "话": "hua4", "东": "dong1",
    "席": "xi2", "次": "ci4", "亲": "qin1", "如": "ru2", "被": "bei4",
    "花": "hua1", "口": "kou3", "放": "fang4", "儿": "er2", "常": "chang2",
    "气": "qi4", "五": "wu3", "第": "di4", "使": "shi3", "写": "xie3",
    "军": "jun1", "吧": "ba5", "文": "wen2", "运": "yun4", "再": "zai4",
    "果": "guo3", "怎": "zen3", "定": "ding4", "许": "xu3", "快": "kuai4",
    "明": "ming2", "行": "xing2", "因": "yin1", "别": "bie2", "飞": "fei1",
    "外": "wai4", "树": "shu4", "物": "wu4", "活": "huo2", "部": "bu4",
    "门": "men2", "无": "wu2", "往": "wang3", "船": "chuan2", "望": "wang4",
    "新": "xin1", "带": "dai4", "队": "dui4", "先": "xian1", "力": "li4",
    "完": "wan2", "却": "que4", "站": "zhan4", "代": "dai4", "员": "yuan2",
    "机": "ji1", "更": "geng4", "九": "jiu3", "您": "nin2", "每": "mei3",
    "风": "feng1", "级": "ji2", "跟": "gen1", "笑": "xiao4", "啊": "a5",
    "孩": "hai2", "万": "wan4", "少": "shao3", "直": "zhi2", "意": "yi4",
    "夜": "ye4", "比": "bi3", "阶": "jie1", "连": "lian2", "车": "che1",
    "重": "zhong4", "便": "bian4", "斗": "dou4", "马": "ma3", "哪": "na3",
    "化": "hua4", "太": "tai4", "指": "zhi3", "变": "bian4", "社": "she4",
    "似": "si4", "士": "shi4", "者": "zhe3", "干": "gan4", "石": "shi2",
    "满": "man3", "日": "ri4", "决": "jue2", "百": "bai3", "原": "yuan2",
    "拿": "na2", "群": "qun2", "究": "jiu1", "各": "ge4", "六": "liu4",
    "本": "ben3", "思": "si1", "解": "jie3", "立": "li4", "河": "he2",
    "村": "cun1", "八": "ba1", "难": "nan2", "早": "zao3", "论": "lun4",
    "吗": "ma5", "根": "gen1", "共": "gong4", "让": "rang4", "相": "xiang1",
    "研": "yan2", "今": "jin1", "其": "qi2", "题": "ti2", "省": "sheng3",
    "听": "ting1", "样": "yang4", "与": "yu3", "皮": "pi2", "边": "bian1",
    "教": "jiao1", "正": "zheng4", "笔": "bi3", "战": "zhan4", "声": "sheng1",
    "七": "qi1", "近": "jin4", "信": "xin4", "脸": "lian3", "句": "ju4",
    "山": "shan1", "字": "zi4", "间": "jian1", "片": "pian4", "爱": "ai4",
    "老": "lao3", "因": "yin1", "房": "fang2", "音": "yin1", "火": "huo3",
    "介": "jie4", "再": "zai4", "做": "zuo4", "觉": "jue2", "轻": "qing1",
    "张": "zhang1", "吃": "chi1", "友": "you3", "求": "qiu2", "毛": "mao2",
    "具": "ju4", "妈": "ma1", "受": "shou4", "挥": "hui1", "名": "ming2",
    "红": "hong2", "快": "kuai4", "场": "chang3", "青": "qing1", "领": "ling3",
    "确": "que4", "传": "chuan2", "海": "hai3", "色": "se4", "金": "jin1",
    "接": "jie1", "校": "xiao4", "爱": "ai4", "元": "yuan2", "肯": "ken3",
    "练": "lian4", "远": "yuan3", "钱": "qian2", "吧": "ba5", "吹": "chui1",
    "乐": "le4", "含": "han2", "坐": "zuo4", "应": "ying1", "低": "di1",
    "收": "shou1", "财": "cai2", "由": "you2", "达": "da2", "冷": "leng3",
    "哥": "ge1", "弟": "di4", "姐": "jie3", "妹": "mei4", "爸": "ba4",
    "妇": "fu4", "食": "shi2", "送": "song4", "切": "qie1", "星": "xing1",
    "晚": "wan3", "错": "cuo4", "买": "mai3", "卖": "mai4", "午": "wu3",
    "读": "du2", "写": "xie3", "书": "shu1", "语": "yu3", "词": "ci2",
    "汉": "han4", "英": "ying1", "法": "fa3", "德": "de2", "美": "mei3",
    "俄": "e2", "意": "yi4", "服": "fu2", "衣": "yi1", "穿": "chuan1",
    "鞋": "xie2", "帽": "mao4", "裤": "ku4", "杯": "bei1", "茶": "cha2",
    "酒": "jiu3", "饭": "fan4", "菜": "cai4", "肉": "rou4", "鱼": "yu2",
    "蛋": "dan4", "奶": "nai3", "糖": "tang2", "盐": "yan2", "水": "shui3",
    "果": "guo3", "苹": "ping2", "香": "xiang1", "蕉": "jiao1", "梨": "li2",
    "桃": "tao2", "瓜": "gua1", "米": "mi3", "面": "mian4", "包": "bao1",
    "汤": "tang1", "喝": "he1", "渴": "ke3", "饿": "e4", "饱": "bao3",
    "猫": "mao1", "狗": "gou3", "鸟": "niao3", "鸡": "ji1", "猪": "zhu1",
    "羊": "yang2", "牛": "niu2", "虎": "hu3", "兔": "tu4", "龙": "long2",
    "蛇": "she2", "猴": "hou2", "熊": "xiong2", "象": "xiang4", "鹿": "lu4",
    "狼": "lang2", "虫": "chong2", "草": "cao3", "叶": "ye4", "林": "lin2",
    "森": "sen1", "花": "hua1", "树": "shu4", "根": "gen1", "种": "zhong3",
    "春": "chun1", "夏": "xia4", "秋": "qiu1", "冬": "dong1", "季": "ji4",
    "节": "jie2", "假": "jia3", "雨": "yu3", "雪": "xue3", "云": "yun2",
    "雷": "lei2", "电": "dian4", "风": "feng1", "冰": "bing1", "热": "re4",
    "温": "wen1", "凉": "liang2", "晴": "qing2", "阴": "yin1", "月": "yue4",
    "星": "xing1", "空": "kong1", "阳": "yang2", "田": "tian2",
    "土": "tu3", "岩": "yan2", "沙": "sha1", "湖": "hu2", "江": "jiang1",
    "池": "chi2", "井": "jing3", "泉": "quan2", "波": "bo1", "浪": "lang4",
    "岛": "dao3", "岸": "an4", "桥": "qiao2", "街": "jie1", "城": "cheng2",
    "市": "shi4", "县": "xian4", "区": "qu1", "镇": "zhen4", "乡": "xiang1",
    "州": "zhou1", "京": "jing1", "港": "gang3", "台": "tai2",
    "楼": "lou2", "层": "ceng2", "房": "fang2", "屋": "wu1", "室": "shi4",
    "厅": "ting1", "厨": "chu2", "厕": "ce4", "窗": "chuang1", "床": "chuang2",
    "桌": "zhuo1", "椅": "yi3", "灯": "deng1", "门": "men2", "墙": "qiang2",
    "院": "yuan4", "园": "yuan2", "店": "dian4", "馆": "guan3", "厂": "chang3",
    "场": "chang3", "站": "zhan4", "局": "ju2", "所": "suo3", "医": "yi1",
    "药": "yao4", "病": "bing4", "疼": "teng2", "痛": "tong4", "伤": "shang1",
    "治": "zhi4", "健": "jian4", "康": "kang1", "体": "ti3", "身": "shen1",
    "头": "tou2", "脑": "nao3", "眼": "yan3", "耳": "er3", "鼻": "bi2",
    "嘴": "zui3", "牙": "ya2", "舌": "she2", "脖": "bo2", "肩": "jian1",
    "背": "bei4", "胸": "xiong1", "肚": "du4", "腿": "tui3", "脚": "jiao3",
    "指": "zhi3", "血": "xue4", "骨": "gu3", "肤": "fu1", "汗": "han4",
    "泪": "lei4", "梦": "meng4", "睡": "shui4", "醒": "xing3", "休": "xiu1",
    "息": "xi1", "累": "lei4", "忙": "mang2", "闲": "xian2", "静": "jing4",
    "闹": "nao4", "吵": "chao3", "安": "an1", "危": "wei1", "险": "xian3",
    "全": "quan2", "保": "bao3", "护": "hu4", "救": "jiu4", "帮": "bang1",
    "助": "zhu4", "谢": "xie4", "请": "qing3", "问": "wen4", "答": "da2",
    "告": "gao4", "诉": "su4", "讲": "jiang3", "谈": "tan2", "议": "yi4",
    "论": "lun4", "评": "ping2", "批": "pi1", "夸": "kua1", "骂": "ma4",
    "哭": "ku1", "喊": "han3", "唱": "chang4", "歌": "ge1", "舞": "wu3",
    "跳": "tiao4", "跑": "pao3", "爬": "pa2", "游": "you2", "泳": "yong3",
    "踢": "ti1", "球": "qiu2", "赛": "sai4", "赢": "ying2", "输": "shu1",
    "玩": "wan2", "棋": "qi2", "画": "hua4", "图": "tu2", "照": "zhao4",
    "拍": "pai1", "摄": "she4", "影": "ying3", "视": "shi4", "播": "bo1",
    "闻": "wen2", "报": "bao4", "纸": "zhi3", "刊": "kan1", "志": "zhi4",
    "版": "ban3", "印": "yin4", "刷": "shua1", "剧": "ju4", "戏": "xi4",
    "演": "yan3", "奏": "zou4", "琴": "qin2", "鼓": "gu3", "号": "hao4",
    "曲": "qu3", "调": "diao4", "韵": "yun4", "诗": "shi1", "歌": "ge1",
    "史": "shi3", "古": "gu3", "旧": "jiu4", "新": "xin1", "久": "jiu3",
    "永": "yong3", "暂": "zan4", "短": "duan3", "延": "yan2", "迟": "chi2",
    "早": "zao3", "晨": "chen2", "夜": "ye4", "晚": "wan3", "昨": "zuo2",
    "明": "ming2", "周": "zhou1", "末": "mo4", "初": "chu1", "终": "zhong1",
    "始": "shi3", "段": "duan4", "程": "cheng2", "途": "tu2", "旅": "lv3",
    "游": "you2", "玩": "wan2", "票": "piao4", "证": "zheng4", "卡": "ka3",
    "银": "yin2", "币": "bi4", "付": "fu4", "费": "fei4", "价": "jia4",
    "贵": "gui4", "宜": "yi2", "租": "zu1", "借": "jie4", "换": "huan4",
    "存": "cun2", "取": "qu3", "送": "song4", "递": "di4", "邮": "you2",
    "寄": "ji4", "收": "shou1", "发": "fa1", "传": "chuan2", "递": "di4",
    "网": "wang3", "线": "xian4", "号": "hao4", "码": "ma3", "键": "jian4",
    "屏": "ping2", "幕": "mu4", "机": "ji1", "器": "qi4", "修": "xiu1",
    "坏": "huai4", "换": "huan4", "装": "zhuang1", "卸": "xie4", "试": "shi4",
    "验": "yan4", "查": "cha2", "检": "jian3", "测": "ce4", "算": "suan4",
    "计": "ji4", "数": "shu4", "量": "liang4", "称": "cheng1", "秤": "cheng4",
    "尺": "chi3", "寸": "cun4", "米": "mi3", "克": "ke4", "斤": "jin1",
    "吨": "dun1", "升": "sheng1", "加": "jia1", "减": "jian3", "乘": "cheng2",
    "除": "chu2", "等": "deng3", "零": "ling2", "半": "ban4", "双": "shuang1",
    "对": "dui4", "单": "dan1", "偶": "ou3", "奇": "qi2", "整": "zheng3",
    "余": "yu2", "倍": "bei4", "率": "lv4", "比": "bi3", "均": "jun1",
    "概": "gai4", "约": "yue1", "估": "gu1", "准": "zhun3", "精": "jing1",
    "细": "xi4", "粗": "cu1", "宽": "kuan1", "窄": "zhai3", "厚": "hou4",
    "薄": "bao2", "深": "shen1", "浅": "qian3", "高": "gao1", "矮": "ai3",
    "胖": "pang4", "瘦": "shou4", "壮": "zhuang4", "弱": "ruo4", "强": "qiang2",
    "硬": "ying4", "软": "ruan3", "紧": "jin3", "松": "song1", "密": "mi4",
    "疏": "shu1", "满": "man3", "空": "kong1", "虚": "xu1", "实": "shi2",
    "真": "zhen1", "假": "jia3", "对": "dui4", "错": "cuo4", "正": "zheng4",
    "反": "fan3", "好": "hao3", "坏": "huai4", "美": "mei3", "丑": "chou3",
    "善": "shan4", "恶": "e4", "净": "jing4", "脏": "zang1", "亮": "liang4",
    "暗": "an4", "黑": "hei1", "白": "bai2", "红": "hong2", "黄": "huang2",
    "蓝": "lan2", "绿": "lv4", "紫": "zi3", "灰": "hui1", "粉": "fen3",
    "棕": "zong1", "橙": "cheng2", "彩": "cai3", "颜": "yan2", "色": "se4",
    "形": "xing2", "状": "zhuang4", "圆": "yuan2", "方": "fang1", "角": "jiao3",
    "尖": "jian1", "平": "ping2", "弯": "wan1", "曲": "qu3", "斜": "xie2",
    "横": "heng2", "竖": "shu4", "左": "zuo3", "右": "you4", "东": "dong1",
    "南": "nan2", "西": "xi1", "北": "bei3", "内": "nei4", "外": "wai4",
    "旁": "pang2", "邻": "lin2", "隔": "ge2", "距": "ju4", "离": "li2",
    "环": "huan2", "绕": "rao4", "围": "wei2", "转": "zhuan3", "移": "yi2",
    "挪": "nuo2", "搬": "ban1", "运": "yun4", "载": "zai4", "托": "tuo1",
    "抬": "tai2", "举": "ju3", "提": "ti2", "拉": "la1", "推": "tui1",
    "拖": "tuo1", "抱": "bao4", "背": "bei4", "扛": "kang2", "挑": "tiao1",
    "担": "dan1", "扔": "reng1", "丢": "diu1", "抛": "pao1", "接": "jie1",
    "捡": "jian3", "拾": "shi2", "抓": "zhua1", "握": "wo4", "捏": "nie1",
    "摸": "mo1", "碰": "peng4", "撞": "zhuang4", "敲": "qiao1", "拍": "pai1",
    "击": "ji1", "踩": "cai3", "踏": "ta4", "蹬": "deng1", "登": "deng1",
    "爬": "pa2", "滚": "gun3", "滑": "hua2", "摔": "shuai1", "跌": "die1",
    "倒": "dao3", "立": "li4", "站": "zhan4", "蹲": "dun1", "躺": "tang3",
    "趴": "pa1", "靠": "kao4", "倚": "yi3", "蹦": "beng4", "跃": "yue4",
    "冲": "chong1", "奔": "ben1", "追": "zhui1", "赶": "gan3", "逃": "tao2",
    "躲": "duo3", "藏": "cang2", "寻": "xun2", "找": "zhao3", "搜": "sou1",
    "失": "shi1", "丢": "diu1", "获": "huo4", "留": "liu2", "剩": "sheng4",
    "余": "yu2", "缺": "que1", "补": "bu3", "添": "tian1", "增": "zeng1",
    "减": "jian3", "除": "chu2", "消": "xiao1", "灭": "mie4", "毁": "hui3",
    "坏": "huai4", "破": "po4", "裂": "lie4", "碎": "sui4", "断": "duan4",
    "折": "zhe2", "弯": "wan1", "扭": "niu3", "拧": "ning2", "撕": "si1",
    "剪": "jian3", "切": "qie1", "割": "ge1", "砍": "kan3", "劈": "pi1",
    "锯": "ju4", "钻": "zuan1", "挖": "wa1", "埋": "mai2", "填": "tian2",
    "盖": "gai4", "遮": "zhe1", "盖": "gai4", "包": "bao1", "裹": "guo3",
    "捆": "kun3", "绑": "bang3", "系": "xi4", "解": "jie3", "开": "kai1",
    "关": "guan1", "锁": "suo3", "封": "feng1", "贴": "tie1", "粘": "zhan1",
    "挂": "gua4", "吊": "diao4", "钉": "ding1", "插": "cha1", "拔": "ba2",
    "塞": "sai1", "灌": "guan4", "倒": "dao3", "洒": "sa3", "泼": "po1",
    "滴": "di1", "流": "liu2", "淌": "tang3", "渗": "shen4", "漏": "lou4",
    "涨": "zhang3", "退": "tui4", "淹": "yan1", "浮": "fu2", "沉": "chen2",
    "漂": "piao1", "洗": "xi3", "刷": "shua1", "擦": "ca1", "抹": "mo3",
    "扫": "sao3", "拖": "tuo1", "晾": "liang4", "晒": "shai4", "烤": "kao3",
    "烧": "shao1", "煮": "zhu3", "蒸": "zheng1", "炒": "chao3", "炸": "zha2",
    "煎": "jian1", "炖": "dun4", "拌": "ban4", "切": "qie1", "剥": "bao1",
    "削": "xiao1", "磨": "mo2", "压": "ya1", "榨": "zha4", "挤": "ji3",
    "捣": "dao3", "搅": "jiao3", "泡": "pao4", "腌": "yan1", "冻": "dong4",
    "化": "hua4", "融": "rong2", "凝": "ning2", "固": "gu4", "液": "ye4",
    "汽": "qi4", "烟": "yan1", "雾": "wu4", "尘": "chen2", "灰": "hui1",
    "油": "you2", "脂": "zhi1", "蜡": "la4", "胶": "jiao1", "漆": "qi1",
    "墨": "mo4", "铁": "tie3", "钢": "gang1", "铜": "tong2", "铝": "lv3",
    "锡": "xi1", "铅": "qian1", "锌": "xin1", "矿": "kuang4", "煤": "mei2",
    "炭": "tan4", "玻": "bo1", "璃": "li2", "瓷": "ci2", "陶": "tao2",
    "砖": "zhuan1", "瓦": "wa3", "泥": "ni2", "塑": "su4", "料": "liao4",
    "橡": "xiang4", "棉": "mian2", "麻": "ma2", "丝": "si1", "绸": "chou2",
    "布": "bu4", "皮": "pi2", "革": "ge2", "毛": "mao2", "绒": "rong2",
    "线": "xian4", "绳": "sheng2", "带": "dai4", "链": "lian4", "环": "huan2",
    "圈": "quan1", "网": "wang3", "袋": "dai4", "箱": "xiang1", "盒": "he2",
    "桶": "tong3", "罐": "guan4", "瓶": "ping2", "壶": "hu2", "碗": "wan3",
    "盘": "pan2", "碟": "die2", "勺": "shao2", "筷": "kuai4", "叉": "cha1",
    "刀": "dao1", "锅": "guo1", "炉": "lu2", "灶": "zao4", "柜": "gui4",
    "架": "jia4", "箱": "xiang1", "篮": "lan2", "筐": "kuang1", "梯": "ti1",
    "凳": "deng4", "镜": "jing4", "梳": "shu1", "刷": "shua1", "巾": "jin1",
    "伞": "san3", "扇": "shan4", "钟": "zhong1", "表": "biao3", "针": "zhen1",
    "剪": "jian3", "尺": "chi3", "笔": "bi3", "墨": "mo4", "纸": "zhi3",
    "砚": "yan4", "橡": "xiang4", "胶": "jiao1", "夹": "jia1", "订": "ding4",
    "册": "ce4", "页": "ye4", "章": "zhang1", "节": "jie2", "篇": "pian1",
    "段": "duan4", "句": "ju4", "词": "ci2", "字": "zi4", "母": "mu3",
    "拼": "pin1", "读": "du2", "念": "nian4", "背": "bei4", "默": "mo4",
    "抄": "chao1", "译": "yi4", "注": "zhu4", "释": "shi4", "义": "yi4",
    "培": "pei2", "训": "xun4", "考": "kao3", "测": "ce4", "卷": "juan4",
    "题": "ti2", "答": "da2", "案": "an4", "析": "xi1", "探": "tan4",
    "索": "suo3", "创": "chuang4", "造": "zao4", "设": "she4", "制": "zhi4",
    "做": "zuo4", "建": "jian4", "筑": "zhu4",
    # supplement: common characters missed by the first pass
    "公": "gong1", "散": "san4", "步": "bu4", "历": "li4", "欢": "huan1",
    "迎": "ying2", "习": "xi2", "记": "ji4", "忆": "yi4", "忘": "wang4",
    "念": "nian4", "感": "gan3", "恩": "en1", "愿": "yuan4", "希": "xi1",
    "盼": "pan4", "期": "qi1", "待": "dai4", "预": "yu4", "或": "huo4",
    "若": "ruo4", "虽": "sui1", "且": "qie3", "并": "bing4", "则": "ze2",
    "即": "ji2", "既": "ji4", "必": "bi4", "须": "xu1", "需": "xu1",
    "能": "neng2", "该": "gai1", "敢": "gan3", "肯": "ken3", "懂": "dong3",
    "记": "ji4", "识": "shi2", "智": "zhi4", "慧": "hui4", "聪": "cong1",
    "谁": "shei2", "某": "mou3", "每": "mei3", "任": "ren4", "凡": "fan2",
    "另": "ling4", "其": "qi2", "彼": "bi3", "此": "ci3", "互": "hu4",
    "术": "shu4", "科": "ke1", "究": "jiu1", "察": "cha2", "观": "guan1",
    "览": "lan3", "显": "xian3", "示": "shi4", "表": "biao3", "达": "da2",
    "述": "shu4", "描": "miao2", "绘": "hui4", "记": "ji4", "录": "lu4",
    "载": "zai4", "编": "bian1", "排": "pai2", "列": "lie4", "序": "xu4",
    "组": "zu3", "织": "zhi1", "构": "gou4", "系": "xi4", "统": "tong3",
    "规": "gui1", "则": "ze2", "律": "lv4", "例": "li4", "式": "shi4",
    "型": "xing2", "类": "lei4", "款": "kuan3", "项": "xiang4", "품": "",
    "任": "ren4", "务": "wu4", "责": "ze2", "职": "zhi2", "权": "quan2",
    "利": "li4", "益": "yi4", "损": "sun3", "害": "hai4", "罚": "fa2",
    "奖": "jiang3", "赏": "shang3", "励": "li4", "努": "nu3", "勤": "qin2",
    "懒": "lan3", "勇": "yong3", "怕": "pa4", "惊": "jing1", "恐": "kong3",
    "慌": "huang1", "忧": "you1", "愁": "chou2", "烦": "fan2", "怒": "nu4",
    "恨": "hen4", "怨": "yuan4", "悔": "hui3", "惜": "xi1", "怜": "lian2",
    "慕": "mu4", "羡": "xian4", "嫉": "ji2", "妒": "du4", "骄": "jiao1",
    "傲": "ao4", "谦": "qian1", "诚": "cheng2", "谎": "huang3", "骗": "pian4",
    "偷": "tou1", "抢": "qiang3", "盗": "dao4", "罪": "zui4", "犯": "fan4",
    "警": "jing3", "捕": "bu3", "审": "shen3", "判": "pan4", "狱": "yu4",
    "政": "zheng4", "府": "fu3", "党": "dang3", "委": "wei3", "官": "guan1",
    "职": "zhi2", "选": "xuan3", "举": "ju3", "投": "tou2", "税": "shui4",
    "贸": "mao4", "易": "yi4", "购": "gou4", "销": "xiao1", "售": "shou4",
    "货": "huo4", "商": "shang1", "业": "ye4", "企": "qi3", "司": "si1",
    "厂": "chang3", "营": "ying2", "管": "guan3", "雇": "gu4", "聘": "pin4",
    "薪": "xin1", "酬": "chou2", "奖": "jiang3", "金": "jin1", "富": "fu4",
    "穷": "qiong2", "贫": "pin2", "债": "zhai4", "赚": "zhuan4", "赔": "pei2",
    "亏": "kui1", "盈": "ying2", "婚": "hun1", "嫁": "jia4", "娶": "qu3",
    "妻": "qi1", "夫": "fu1", "儿": "er2", "女": "nv3", "孙": "sun1",
    "祖": "zu3", "宗": "zong1", "族": "zu2", "戚": "qi1", "邻": "lin2",
    "居": "ju1", "客": "ke4", "宾": "bin1", "主": "zhu3", "仆": "pu2",
    "宣": "xuan1", "济": "ji4", "策": "ce4", "府": "fu3", "效": "xiao4",
    "验": "yan4", "境": "jing4", "况": "kuang4", "величина": "",
    "态": "tai4", "势": "shi4", "局": "ju2", "景": "jing3", "象": "xiang4",
    "征": "zheng1", "兆": "zhao4", "亿": "yi4", "兼": "jian1", "较": "jiao4",
    "超": "chao1", "越": "yue4", "限": "xian4", "制": "zhi4", "止": "zhi3",
    "禁": "jin4", "允": "yun3", "批": "pi1", "准": "zhun3", "证": "zheng4",
    "据": "ju4", "依": "yi1", "按": "an4", "照": "zhao4", "据": "ju4",

    # supplement 2: next frequency tier (~400 chars, toned)
    "位": "wei4", "何": "he2", "供": "gong1", "俱": "ju4", "储": "chu3",
    "入": "ru4", "兵": "bing1", "典": "dian3", "冒": "mao4", "农": "nong2",
    "凑": "cou4", "刚": "gang1", "办": "ban4", "功": "gong1", "博": "bo2",
    "占": "zhan4", "叔": "shu1", "召": "zhao4", "合": "he2", "否": "fou3",
    "启": "qi3", "呀": "ya5", "呜": "wu1", "品": "pin3", "哈": "ha1",
    "响": "xiang3", "哦": "o2", "唉": "ai1", "喂": "wei4", "嗯": "en4",
    "嘛": "ma5", "困": "kun4", "圣": "sheng4", "块": "kuai4", "坚": "jian1",
    "基": "ji1", "堂": "tang2", "堆": "dui1", "塔": "ta3", "壁": "bi4",
    "处": "chu4", "备": "bei4", "够": "gou4", "妙": "miao4", "姑": "gu1",
    "姓": "xing4", "姿": "zi1", "娘": "niang2", "婆": "po2", "嫌": "xian2",
    "孔": "kong3", "孝": "xiao4", "宁": "ning2", "宇": "yu3", "守": "shou3",
    "宝": "bao3", "宴": "yan4", "容": "rong2", "宿": "su4", "寒": "han2",
    "寺": "si4", "导": "dao3", "射": "she4", "将": "jiang1", "尊": "zun1",
    "尚": "shang4", "尝": "chang2", "尤": "you2", "尽": "jin4", "屈": "qu1",
    "属": "shu3", "岁": "sui4", "岂": "qi3", "峰": "feng1", "崇": "chong2",
    "川": "chuan1", "巴": "ba1", "帝": "di4", "幅": "fu2", "幼": "you4",
    "库": "ku4", "底": "di3", "座": "zuo4", "庭": "ting2", "廉": "lian2",
    "引": "yin3", "微": "wei1", "忍": "ren3", "忠": "zhong1", "怀": "huai2",
    "性": "xing4", "恋": "lian4", "恰": "qia4", "悟": "wu4", "患": "huan4",
    "悲": "bei1", "惯": "guan4", "愈": "yu4", "慢": "man4", "户": "hu4",
    "扁": "bian3", "扎": "zha1", "扑": "pu1", "扣": "kou4", "执": "zhi2",
    "扩": "kuo4", "扬": "yang2", "扮": "ban4", "扶": "fu2", "承": "cheng2",
    "技": "ji4", "抗": "kang4", "抚": "fu3", "抽": "chou1", "拒": "ju4",
    "拘": "ju1", "拙": "zhuo1", "招": "zhao1", "拜": "bai4", "拟": "ni3",
    "拥": "yong1", "拳": "quan2", "持": "chi2", "挺": "ting3", "捧": "peng3",
    "摆": "bai3", "摇": "yao2", "撑": "cheng1", "支": "zhi1", "改": "gai3",
    "攻": "gong1", "故": "gu4", "敬": "jing4", "斋": "zhai1", "施": "shi1",
    "旦": "dan4", "旨": "zhi3", "旬": "xun2", "旺": "wang4", "昂": "ang2",
    "昌": "chang1", "昏": "hun1", "映": "ying4", "昼": "zhou4", "晋": "jin4",
    "晓": "xiao3", "暖": "nuan3", "曾": "ceng2", "替": "ti4", "朝": "chao2",
    "木": "mu4", "朱": "zhu1", "杀": "sha1", "杂": "za2", "束": "shu4",
    "杨": "yang2", "板": "ban3", "枯": "ku1", "柔": "rou2", "标": "biao1",
    "栏": "lan2", "格": "ge2", "桂": "gui4", "梁": "liang2", "榜": "bang3",
    "欣": "xin1", "死": "si3", "毅": "yi4", "毫": "hao2", "汇": "hui4",
    "沈": "shen3", "泰": "tai4", "洁": "jie2", "派": "pai4", "浩": "hao4",
    "涉": "she4", "混": "hun4", "清": "qing1", "渡": "du4", "湾": "wan1",
    "源": "yuan2", "溪": "xi1", "滋": "zi1", "滥": "lan4", "漫": "man4",
    "潮": "chao2", "灵": "ling2", "灾": "zai1", "炼": "lian4", "烈": "lie4",
    "煌": "huang2", "熟": "shu2", "燃": "ran2", "爆": "bao4", "父": "fu4",
    "牌": "pai2", "特": "te4", "犹": "you2", "狂": "kuang2", "独": "du2",
    "猛": "meng3", "玉": "yu4", "王": "wang2", "班": "ban1", "瑞": "rui4",
    "甘": "gan1", "甲": "jia3", "申": "shen1", "男": "nan2", "略": "lve4",
    "番": "fan1", "疑": "yi2", "疗": "liao2", "疾": "ji2", "症": "zheng4",
    "痕": "hen2", "皆": "jie1", "皇": "huang2", "盆": "pen2", "监": "jian1",
    "眉": "mei2", "眠": "mian2", "睛": "jing1", "瞧": "qiao2", "础": "chu3",
    "磁": "ci2", "礼": "li3", "神": "shen2", "祥": "xiang2", "祭": "ji4",
    "福": "fu2", "秀": "xiu4", "私": "si1", "秘": "mi4", "积": "ji1",
    "稀": "xi1", "稳": "wen3", "窝": "wo1", "竞": "jing4", "童": "tong2",
    "端": "duan1", "笨": "ben4", "筋": "jin1", "签": "qian1", "简": "jian3",
    "箭": "jian4", "糊": "hu2", "素": "su4", "纯": "chun2", "纹": "wen2",
    "结": "jie2", "继": "ji4", "维": "wei2", "绵": "mian2", "缓": "huan3",
    "缘": "yuan2", "缩": "suo1", "耍": "shua3", "耐": "nai4", "耗": "hao4",
    "聊": "liao2", "联": "lian2", "聚": "ju4", "肃": "su4", "胀": "zhang4",
    "胜": "sheng4", "胞": "bao1", "脆": "cui4", "脱": "tuo1", "腐": "fu3",
    "臂": "bi4", "臭": "chou4", "至": "zhi4", "致": "zhi4", "舍": "she4",
    "良": "liang2", "艺": "yi4", "芳": "fang1", "苦": "ku3", "茫": "mang2",
    "荒": "huang1", "荣": "rong2", "荷": "he2", "莫": "mo4", "菊": "ju2",
    "萌": "meng2", "落": "luo4", "著": "zhu4", "虑": "lv4", "蚁": "yi3",
    "蛮": "man2", "衡": "heng2", "袭": "xi2", "裁": "cai2", "裕": "yu4",
    "覆": "fu4", "触": "chu4", "言": "yan2", "誉": "yu4", "讨": "tao3",
    "讯": "xun4", "访": "fang3", "诞": "dan4", "误": "wu4", "诸": "zhu1",
    "课": "ke4", "谊": "yi4", "谋": "mou2", "谓": "wei4", "谜": "mi2",
    "谨": "jin3", "谱": "pu3", "负": "fu4", "败": "bai4", "质": "zhi4",
    "贯": "guan4", "贺": "he4", "资": "zi1", "赋": "fu4", "赌": "du3",
    "赖": "lai4", "赞": "zan4", "赤": "chi4", "足": "zu2", "跨": "kua4",
    "踪": "zong1", "轨": "gui3", "轮": "lun2", "辅": "fu3", "辆": "liang4",
    "辛": "xin1", "辞": "ci2", "辨": "bian4", "迅": "xun4", "返": "fan3",
    "违": "wei2", "迫": "po4", "适": "shi4", "逆": "ni4", "透": "tou4",
    "逐": "zhu2", "速": "su4", "逢": "feng2", "逼": "bi1", "遇": "yu4",
    "遍": "bian4", "遗": "yi2", "遭": "zao1", "避": "bi4", "邦": "bang1",
    "配": "pei4", "酸": "suan1", "醉": "zui4", "采": "cai3", "野": "ye3",
    "钓": "diao4", "铺": "pu1", "锋": "feng1", "闪": "shan3", "闭": "bi4",
    "闷": "men4", "阁": "ge2", "防": "fang2", "阵": "zhen4", "阿": "a1",
    "附": "fu4", "际": "ji4", "陆": "lu4", "降": "jiang4", "隆": "long2",
    "随": "sui2", "隐": "yin3", "障": "zhang4", "雄": "xiong2", "雅": "ya3",
    "集": "ji2", "震": "zhen4", "鞭": "bian1", "顶": "ding3", "顽": "wan2",
    "顾": "gu4", "顿": "dun4", "频": "pin2", "颤": "chan4", "飘": "piao1",
    "餐": "can1", "饮": "yin3", "饰": "shi4", "驱": "qu1", "驶": "shi3",
    "骑": "qi2", "鬼": "gui3", "魂": "hun2", "魅": "mei4", "鲜": "xian1",
    "鸣": "ming2", "鸿": "hong2", "麦": "mai4", "黎": "li2", "齐": "qi2",
}
for _bad2 in ("величина", ""):
    PINYIN.pop(_bad2, None)
for _bad in ("품", ""):
    PINYIN.pop(_bad, None)

_HAN_RE = re.compile(r"[㐀-鿿豈-﫿]")
_warned_hanzi: set[str] = set()
_warned_yue = [False]


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
    # Multi-char measures first.
    for mw, mpy in _MEASURES.items():
        if len(mw) > 1 and text.startswith(mw, j):
            return number_to_pinyin(int(digits), liang=True) + " " + mpy, j + len(mw)
    nxt = text[j] if j < len(text) else ""
    if nxt in _MEASURES and len(nxt) == 1:
        return (
            number_to_pinyin(int(digits), liang=(nxt not in "年月日号"))
            + " " + _MEASURES[nxt],
            j + 1,
        )
    return number_to_pinyin(int(digits)), j


def _tone_of(syl: str) -> str:
    return syl[-1] if syl and syl[-1] in "12345" else ""


def _apply_sandhi(tokens: list[str], flags: list[str]) -> list[str]:
    """Standard Mandarin tone sandhi over the flat syllable stream.

    ``tokens`` alternates pinyin syllables and separators (space/punct);
    ``flags`` marks the 不/一 syllables eligible for lexical sandhi.
    Rules (applied only across adjacent syllables, never across
    punctuation): 3-3 → 2-3 (right-to-left against the post-sandhi right
    neighbour, so a 3-3-3 run reads 3-2-3), 不 bù→bú
    before tone 4, quantifier 一 yī→yí before 4 / yì before 1-2-3.
    """
    # Indices of syllable tokens with their neighbour relationships.
    syl_idx = [i for i, t in enumerate(tokens) if t and t[0].isalpha()]

    def next_syl(k: int) -> str:
        # The following syllable, unless punctuation intervenes.
        if k + 1 >= len(syl_idx):
            return ""
        i, j = syl_idx[k], syl_idx[k + 1]
        between = "".join(tokens[i + 1 : j])
        if any(c not in " " for c in between):
            return ""
        return tokens[j]

    for k, i in enumerate(syl_idx):
        nxt_tone = _tone_of(next_syl(k))
        if flags[i] == "bu" and nxt_tone == "4":
            tokens[i] = "bu2"
        elif flags[i] == "yi" and nxt_tone:
            if nxt_tone in "45":
                tokens[i] = "yi2"
            elif nxt_tone in "123":
                tokens[i] = "yi4"
    # Third-tone sandhi, right-to-left against the post-sandhi right
    # neighbour, so a 3-3-3 run reads 3-2-3.
    for k in range(len(syl_idx) - 2, -1, -1):
        i = syl_idx[k]
        if _tone_of(tokens[i]) == "3" and _tone_of(next_syl(k)) == "3":
            tokens[i] = tokens[i][:-1] + "2"
    return tokens


def read_chinese(text: str, language: str = "cmn") -> str:
    """hanzi/numeral text → toned pinyin string (space-separated, trailing
    tone digits 1-5; 5 = neutral), with standard sandhi applied.

    Viterbi segmentation over WORDS + single-char PINYIN (same lattice
    design as conditioning/ja.py::_segment); unknown hanzi are dropped with
    one loud warning per character.
    """
    if language.startswith("yue") and not _warned_yue[0]:
        _warned_yue[0] = True
        logger.warning(
            "Cantonese (yue) has no native reading table: reading hanzi with "
            "MANDARIN readings — install espeak-ng for true Cantonese"
        )
    n = len(text)
    COST_WORD_BASE = 9.0
    COST_CHAR = 6.0
    COST_NUM = 3.0
    COST_OTHER = 2.0
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
            py = PINYIN.get(ch)
            if py is not None:
                c = best[i] + COST_CHAR
                if c < best[i + 1]:
                    best[i + 1], back[i + 1] = c, (i, py, "char")
            c = best[i] + COST_DROP
            if c < best[i + 1]:
                best[i + 1], back[i + 1] = c, (i, "", "drop")
        else:
            _PUNCT = {"。": ".", "．": ".", "，": ",", "、": ",", "！": "!",
                      "？": "?", "：": ":", "；": ";", "「": '"', "」": '"',
                      "『": '"', "』": '"', "（": "(", "）": ")", "《": '"',
                      "》": '"', "　": " "}
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

    tokens: list[str] = []
    flags: list[str] = []

    def emit(tok: str, flag: str = "") -> None:
        tokens.append(tok)
        flags.append(flag)

    for reading, kind, surface in pieces:
        if kind == "drop":
            if surface not in _warned_hanzi:
                _warned_hanzi.add(surface)
                logger.warning(
                    "Chinese fallback: no reading for hanzi %r — dropped "
                    "(install espeak-ng for full coverage)", surface,
                )
            continue
        if kind in ("word", "char", "num"):
            if tokens and tokens[-1] and not tokens[-1].endswith(" "):
                emit(" ")
            for si, syl in enumerate(reading.split(" ")):
                if si:
                    emit(" ")
                flag = ""
                if kind == "char" and surface == "不":
                    flag = "bu"
                elif (kind == "char" and surface == "一") or (
                    kind == "num" and si == 0 and syl == "yi1"
                ):
                    flag = "yi"  # quantifier 一, incl. a bare numeral 1
                emit(syl, flag)
        else:
            emit(reading)
    tokens = _apply_sandhi(tokens, flags)
    return "".join(tokens).strip()


def chinese_to_ipa(text: str, language: str = "cmn") -> str:
    """hanzi text → IPA via pinyin, tones as Chao letters (espeak style)."""
    py = read_chinese(text, language)
    out: list[str] = []
    for token in re.split(r"(\s+|[;:,.!?()\"-])", py):
        if not token:
            continue
        if re.fullmatch(r"[a-zv]+[1-5]?", token):
            out.append(pinyin_to_ipa(token))
        else:
            out.append(" " if token.isspace() else token)
    return "".join(out)


def coverage(text: str) -> float:
    """Fraction of hanzi receiving a reading."""
    total = sum(1 for ch in text if _is_hanzi(ch))
    if total == 0:
        return 1.0
    covered = sum(
        1 for ch in text if _is_hanzi(ch)
        and (ch in PINYIN or any(ch in w for w in WORDS))
    )
    return covered / total
