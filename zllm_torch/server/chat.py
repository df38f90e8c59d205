"""Built-in chat template formatters.

The analogue of the reference's llama_chat_apply_template (reference:
src/llama-chat.cpp llm_chat_detect_template / llm_chat_apply_template):
a registry of ~45 formats selected by name or by sniffing the GGUF
tokenizer.chat_template jinja source with the same marker heuristics the
reference uses (it never evaluates jinja either), falling back to arch
defaults.

The port's own copy of `zllm/server/chat.py` (pure Python, the same
behaviour; jinja2 is imported only when a template is rendered).
"""

from __future__ import annotations


def _trim(s: str) -> str:
    return s.strip()


def _fmt_chatml(msgs, add_ass):
    out = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in msgs]
    if add_ass:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _fmt_mistral_v7(msgs, add_ass, sp=" "):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(f"[SYSTEM_PROMPT]{sp}{m['content']}[/SYSTEM_PROMPT]")
        elif m["role"] == "user":
            out.append(f"[INST]{sp}{m['content']}[/INST]")
        else:
            out.append(f"{sp}{m['content']}</s>")
    return "".join(out)


def _fmt_mistral_v3(msgs, add_ass, lead="", trail=" ", trim_ass=True):
    out, inside = [], False
    for m in msgs:
        if not inside:
            out.append(f"{lead}[INST]{trail}")
            inside = True
        if m["role"] == "system":
            out.append(m["content"] + "\n\n")
        elif m["role"] == "user":
            out.append(m["content"] + lead + "[/INST]")
        else:
            c = _trim(m["content"]) if trim_ass else m["content"]
            out.append(trail + c + "</s>")
            inside = False
    return "".join(out)


def _fmt_llama2(msgs, add_ass, support_sys=True, bos_hist=False, strip=False):
    out, inside = ["[INST] "], True
    for m in msgs:
        content = _trim(m["content"]) if strip else m["content"]
        if not inside:
            inside = True
            out.append("<s>[INST] " if bos_hist else "[INST] ")
        if m["role"] == "system":
            out.append(f"<<SYS>>\n{content}\n<</SYS>>\n\n" if support_sys else content + "\n")
        elif m["role"] == "user":
            out.append(content + " [/INST]")
        else:
            out.append(content + "</s>")
            inside = False
    return "".join(out)


def _fmt_phi3(msgs, add_ass):
    out = [f"<|{m['role']}|>\n{m['content']}<|end|>\n" for m in msgs]
    if add_ass:
        out.append("<|assistant|>\n")
    return "".join(out)


def _fmt_phi4(msgs, add_ass):
    out = [f"<|im_start|>{m['role']}<|im_sep|>{m['content']}<|im_end|>" for m in msgs]
    if add_ass:
        out.append("<|im_start|>assistant<|im_sep|>")
    return "".join(out)


def _fmt_falcon3(msgs, add_ass):
    out = [f"<|{m['role']}|>\n{m['content']}\n" for m in msgs]
    if add_ass:
        out.append("<|assistant|>\n")
    return "".join(out)


def _fmt_zephyr(msgs, add_ass):
    out = [f"<|{m['role']}|>\n{m['content']}<|endoftext|>\n" for m in msgs]
    if add_ass:
        out.append("<|assistant|>\n")
    return "".join(out)


def _fmt_monarch(msgs, add_ass):
    out = [
        ("" if i == 0 else "<s>") + f"{m['role']}\n{m['content']}</s>\n"
        for i, m in enumerate(msgs)
    ]
    if add_ass:
        out.append("<s>assistant\n")
    return "".join(out)


def _fmt_gemma(msgs, add_ass):
    out, system = [], ""
    for m in msgs:
        if m["role"] == "system":
            system += _trim(m["content"])
            continue
        role = "model" if m["role"] == "assistant" else m["role"]
        out.append(f"<start_of_turn>{role}\n")
        if system and role != "model":
            out.append(system + "\n\n")
            system = ""
        out.append(_trim(m["content"]) + "<end_of_turn>\n")
    if add_ass:
        out.append("<start_of_turn>model\n")
    return "".join(out)


def _fmt_orion(msgs, add_ass):
    out, system = [], ""
    for m in msgs:
        if m["role"] == "system":
            system += m["content"]
        elif m["role"] == "user":
            out.append("Human: ")
            if system:
                out.append(system + "\n\n")
                system = ""
            out.append(m["content"] + "\n\nAssistant: </s>")
        else:
            out.append(m["content"] + "</s>")
    return "".join(out)


def _fmt_openchat(msgs, add_ass):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(m["content"] + "<|end_of_turn|>")
        else:
            out.append(f"GPT4 Correct {m['role'].capitalize()}: {m['content']}<|end_of_turn|>")
    if add_ass:
        out.append("GPT4 Correct Assistant:")
    return "".join(out)


def _fmt_vicuna(msgs, add_ass, orca=False):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(f"SYSTEM: {m['content']}\n" if orca else m["content"] + "\n\n")
        elif m["role"] == "user":
            out.append(f"USER: {m['content']}\n")
        else:
            out.append(f"ASSISTANT: {m['content']}</s>\n")
    if add_ass:
        out.append("ASSISTANT:")
    return "".join(out)


def _fmt_deepseek(msgs, add_ass):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(m["content"])
        elif m["role"] == "user":
            out.append(f"### Instruction:\n{m['content']}\n")
        else:
            out.append(f"### Response:\n{m['content']}\n<|EOT|>\n")
    if add_ass:
        out.append("### Response:\n")
    return "".join(out)


def _fmt_deepseek2(msgs, add_ass):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(m["content"] + "\n\n")
        elif m["role"] == "user":
            out.append(f"User: {m['content']}\n\n")
        else:
            out.append(f"Assistant: {m['content']}<｜end▁of▁sentence｜>")
    if add_ass:
        out.append("Assistant:")
    return "".join(out)


def _fmt_deepseek3(msgs, add_ass):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(m["content"] + "\n\n")
        elif m["role"] == "user":
            out.append("<｜User｜>" + m["content"])
        else:
            out.append("<｜Assistant｜>" + m["content"] + "<｜end▁of▁sentence｜>")
    if add_ass:
        out.append("<｜Assistant｜>")
    return "".join(out)


def _fmt_command_r(msgs, add_ass):
    roles = {"system": "SYSTEM", "user": "USER", "assistant": "CHATBOT"}
    out = [
        f"<|START_OF_TURN_TOKEN|><|{roles.get(m['role'], 'USER')}_TOKEN|>"
        f"{_trim(m['content'])}<|END_OF_TURN_TOKEN|>"
        for m in msgs
    ]
    if add_ass:
        out.append("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>")
    return "".join(out)


def _fmt_llama3(msgs, add_ass):
    out = [
        f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{_trim(m['content'])}<|eot_id|>"
        for m in msgs
    ]
    if add_ass:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _fmt_llama4(msgs, add_ass):
    out = [
        f"<|header_start|>{m['role']}<|header_end|>\n\n{_trim(m['content'])}<|eot|>"
        for m in msgs
    ]
    if add_ass:
        out.append("<|header_start|>assistant<|header_end|>\n\n")
    return "".join(out)


def _fmt_chatglm3(msgs, add_ass):
    out = ["[gMASK]sop"] + [f"<|{m['role']}|>\n {m['content']}" for m in msgs]
    if add_ass:
        out.append("<|assistant|>")
    return "".join(out)


def _fmt_chatglm4(msgs, add_ass):
    out = ["[gMASK]<sop>"] + [f"<|{m['role']}|>\n{m['content']}" for m in msgs]
    if add_ass:
        out.append("<|assistant|>\n")
    return "".join(out)


def _fmt_glmedge(msgs, add_ass):
    out = [f"<|{m['role']}|>\n{m['content']}" for m in msgs]
    if add_ass:
        out.append("<|assistant|>")
    return "".join(out)


def _fmt_minicpm(msgs, add_ass):
    out = []
    for m in msgs:
        if m["role"] == "user":
            out.append("<用户>" + _trim(m["content"]) + "<AI>")
        else:
            out.append(_trim(m["content"]))
    return "".join(out)


def _fmt_exaone3(msgs, add_ass, tool=False, moe=False):
    pre, post = ("<|", "|>\n") if moe else ("[|", "|]")
    end = "<|endofturn|>\n" if moe else "[|endofturn|]\n"
    out = []
    for m in msgs:
        c = _trim(m["content"])
        if m["role"] == "system":
            out.append(f"{pre}system{post}{c}{end}")
        elif m["role"] == "user":
            out.append(f"{pre}user{post}{c}" + (end if moe else "\n"))
        elif m["role"] == "assistant":
            out.append(f"{pre}assistant{post}{c}{end}")
        elif m["role"] == "tool" and (tool or moe):
            out.append(f"{pre}tool{post}{c}{end}")
    if add_ass:
        out.append(f"{pre}assistant{post}" if moe else "[|assistant|]")
    return "".join(out)


def _fmt_rwkv_world(msgs, add_ass):
    out = []
    for i, m in enumerate(msgs):
        c = _trim(m["content"])
        if m["role"] == "system":
            out.append(f"System: {c}\n\n")
        elif m["role"] == "user":
            out.append(f"User: {c}\n\n")
            if i == len(msgs) - 1:
                out.append("Assistant:")
        else:
            out.append(f"Assistant: {c}\n\n")
    return "".join(out)


def _fmt_granite(msgs, add_ass):
    out = []
    for m in msgs:
        out.append(f"<|start_of_role|>{m['role']}<|end_of_role|>")
        if m["role"] == "assistant_tool_call":
            out.append("<|tool_call|>")
        out.append(m["content"] + "<|end_of_text|>\n")
    if add_ass:
        out.append("<|start_of_role|>assistant<|end_of_role|>")
    return "".join(out)


def _fmt_gigachat(msgs, add_ass):
    out = []
    rest = msgs
    if msgs and msgs[0]["role"] == "system":
        out.append("<s>" + msgs[0]["content"] + "<|message_sep|>")
        rest = msgs[1:]
    else:
        out.append("<s>")
    for m in rest:
        if m["role"] == "user":
            out.append(
                f"user<|role_sep|>{m['content']}<|message_sep|>"
                "available functions<|role_sep|>[]<|message_sep|>"
            )
        elif m["role"] == "assistant":
            out.append(f"assistant<|role_sep|>{m['content']}<|message_sep|>")
    if add_ass:
        out.append("assistant<|role_sep|>")
    return "".join(out)


def _fmt_megrez(msgs, add_ass):
    out = [f"<|role_start|>{m['role']}<|role_end|>{m['content']}<|turn_end|>" for m in msgs]
    if add_ass:
        out.append("<|role_start|>assistant<|role_end|>")
    return "".join(out)


def _fmt_yandex(msgs, add_ass):
    out = []
    for m in msgs:
        if m["role"] == "user":
            out.append(f" Пользователь: {m['content']}\n\n")
        elif m["role"] == "assistant":
            out.append(f" Ассистент: {m['content']}\n\n")
    if add_ass:
        out.append(" Ассистент:[SEP]")
    return "".join(out)


def _fmt_bailing(msgs, add_ass, think=False, v2=False):
    out = []
    if v2 and not (msgs and msgs[0]["role"] == "system"):
        out.append("<role>SYSTEM</role>detailed thinking off<|role_end|>")
    for m in msgs:
        role = "HUMAN" if m["role"] == "user" else m["role"].upper()
        out.append(f"<role>{role}</role>{m['content']}" + ("<|role_end|>" if v2 else ""))
    if add_ass:
        out.append("<role>ASSISTANT</role>")
        if think:
            out.append("<think>")
    return "".join(out)


def _fmt_smolvlm(msgs, add_ass):
    out = ["<|im_start|>"]
    for m in msgs:
        if m["role"] == "system":
            out.append(m["content"] + "\n\n")
        elif m["role"] == "user":
            out.append(f"User: {m['content']}<end_of_utterance>\n")
        else:
            out.append(f"Assistant: {m['content']}<end_of_utterance>\n")
    if add_ass:
        out.append("Assistant:")
    return "".join(out)


def _fmt_dots1(msgs, add_ass):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(f"<|system|>{m['content']}<|endofsystem|>")
        elif m["role"] == "user":
            out.append(f"<|userprompt|>{m['content']}<|endofuserprompt|>")
        else:
            out.append(f"<|response|>{m['content']}<|endofresponse|>")
    if add_ass:
        out.append("<|response|>")
    return "".join(out)


def _fmt_hunyuan_moe(msgs, add_ass):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(f"<|startoftext|>{m['content']}<|extra_4|>")
        elif m["role"] == "assistant":
            out.append(m["content"] + "<|eos|>")
        else:
            out.append(f"<|startoftext|>{m['content']}<|extra_0|>")
    return "".join(out)


def _fmt_hunyuan_dense(msgs, add_ass):
    out = []
    for i, m in enumerate(msgs):
        if i == 0 and m["role"] == "system":
            out.append(m["content"] + "<｜hy_place▁holder▁no▁3｜>")
        if m["role"] == "assistant":
            out.append("<｜hy_Assistant｜>" + m["content"] + "<｜hy_place▁holder▁no▁2｜>")
        elif m["role"] == "user":
            out.append("<｜hy_User｜>" + m["content"] + "<｜hy_Assistant｜>")
    return "".join(out)


def _fmt_openai_moe(msgs, add_ass):
    out = [
        f"<|start|>{m['role']}<|message|>{m['content']}"
        + ("<|return|>" if m["role"] == "assistant" else "<|end|>")
        for m in msgs
    ]
    if add_ass:
        out.append("<|start|>assistant")
    return "".join(out)


def _fmt_kimi_k2(msgs, add_ass):
    heads = {
        "system": "<|im_system|>system<|im_middle|>",
        "user": "<|im_user|>user<|im_middle|>",
        "assistant": "<|im_assistant|>assistant<|im_middle|>",
        "tool": "<|im_system|>tool<|im_middle|>",
    }
    out = [heads.get(m["role"], "") + m["content"] + "<|im_end|>" for m in msgs]
    if add_ass:
        out.append("<|im_assistant|>assistant<|im_middle|>")
    return "".join(out)


def _fmt_seed_oss(msgs, add_ass):
    out = [
        f"<seed:bos>{m['role']}\n"
        + (_trim(m["content"]) if m["role"] == "assistant" else m["content"])
        + "<seed:eos>"
        for m in msgs
    ]
    if add_ass:
        out.append("<seed:bos>assistant\n")
    return "".join(out)


def _fmt_grok2(msgs, add_ass):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(f"System: {_trim(m['content'])}<|separator|>\n\n")
        elif m["role"] == "user":
            out.append(f"Human: {_trim(m['content'])}<|separator|>\n\n")
        else:
            out.append(f"Assistant: {m['content']}<|separator|>\n\n")
    if add_ass:
        out.append("Assistant:")
    return "".join(out)


def _fmt_pangu(msgs, add_ass):
    names = {"system": "系统：", "user": "用户：", "assistant": "助手：",
             "tool": "工具：", "function": "方法："}
    out = []
    for i, m in enumerate(msgs):
        if i == 0 and m["role"] != "system":
            out.append("[unused9]系统：[unused10]")
        if m["role"] in names:
            out.append(f"[unused9]{names[m['role']]}{m['content']}[unused10]")
    if add_ass:
        out.append("[unused9]助手：")
    return "".join(out)


def _fmt_solar(msgs, add_ass):
    out = [f"<|begin|>{m['role']}<|content|>{m['content']}<|end|>" for m in msgs]
    if add_ass:
        out.append("<|begin|>assistant")
    return "".join(out)


# named formats (reference LLM_CHAT_TEMPLATES map, src/llama-chat.cpp)
FORMATS: dict = {
    "chatml": _fmt_chatml,
    "llama2": lambda m, a: _fmt_llama2(m, a, support_sys=False),
    "llama2-sys": _fmt_llama2,
    "llama2-sys-bos": lambda m, a: _fmt_llama2(m, a, bos_hist=True),
    "llama2-sys-strip": lambda m, a: _fmt_llama2(m, a, strip=True),
    "mistral-v1": lambda m, a: _fmt_mistral_v3(m, a, lead=" ", trim_ass=False),
    "mistral-v3": _fmt_mistral_v3,
    "mistral-v3-tekken": lambda m, a: _fmt_mistral_v3(m, a, trail="", trim_ass=False),
    "mistral-v7": _fmt_mistral_v7,
    "mistral-v7-tekken": lambda m, a: _fmt_mistral_v7(m, a, sp=""),
    "phi3": _fmt_phi3,
    "phi4": _fmt_phi4,
    "falcon3": _fmt_falcon3,
    "zephyr": _fmt_zephyr,
    "monarch": _fmt_monarch,
    "gemma": _fmt_gemma,
    "orion": _fmt_orion,
    "openchat": _fmt_openchat,
    "vicuna": _fmt_vicuna,
    "vicuna-orca": lambda m, a: _fmt_vicuna(m, a, orca=True),
    "deepseek": _fmt_deepseek,
    "deepseek2": _fmt_deepseek2,
    "deepseek3": _fmt_deepseek3,
    "command-r": _fmt_command_r,
    "llama3": _fmt_llama3,
    "llama4": _fmt_llama4,
    "chatglm3": _fmt_chatglm3,
    "chatglm4": _fmt_chatglm4,
    "glmedge": _fmt_glmedge,
    "minicpm": _fmt_minicpm,
    "exaone3": _fmt_exaone3,
    "exaone4": lambda m, a: _fmt_exaone3(m, a, tool=True),
    "exaone-moe": lambda m, a: _fmt_exaone3(m, a, moe=True),
    "rwkv-world": _fmt_rwkv_world,
    "granite": _fmt_granite,
    "gigachat": _fmt_gigachat,
    "megrez": _fmt_megrez,
    "yandex": _fmt_yandex,
    "bailing": _fmt_bailing,
    "bailing-think": lambda m, a: _fmt_bailing(m, a, think=True),
    "bailing2": lambda m, a: _fmt_bailing(m, a, v2=True),
    "smolvlm": _fmt_smolvlm,
    "dots1": _fmt_dots1,
    "hunyuan-moe": _fmt_hunyuan_moe,
    "hunyuan-dense": _fmt_hunyuan_dense,
    "gpt-oss": _fmt_openai_moe,
    "kimi-k2": _fmt_kimi_k2,
    "seed-oss": _fmt_seed_oss,
    "grok-2": _fmt_grok2,
    "pangu": _fmt_pangu,
    "solar-open": _fmt_solar,
}


def detect_format(model) -> str:
    """Map the model's raw jinja template to a named builtin format
    (reference: llm_chat_detect_template's substring heuristics,
    src/llama-chat.cpp)."""
    tmpl = getattr(model, "chat_template", "") or ""
    arch = model.cfg.arch
    if tmpl in FORMATS:
        return tmpl
    has = lambda s: s in tmpl  # noqa: E731
    if has("<|im_start|>"):
        if has("<|im_sep|>"):
            return "phi4"
        return "smolvlm" if has("<end_of_utterance>") else "chatml"
    if tmpl.startswith("mistral") or has("[INST]"):
        if has("[SYSTEM_PROMPT]"):
            return "mistral-v7"
        if has("' [INST] ' + system_message") or has("[AVAILABLE_TOOLS]"):
            if has(" [INST]"):
                return "mistral-v1"
            if has('"[INST]"'):
                return "mistral-v3-tekken"
            return "mistral-v3"
        if has("content.strip()"):
            return "llama2-sys-strip"
        if has("bos_token + '[INST]"):
            return "llama2-sys-bos"
        return "llama2-sys" if has("<<SYS>>") else "llama2"
    if has("<|assistant|>") and has("<|end|>"):
        return "phi3"
    if has("[gMASK]<sop>"):
        return "chatglm4"
    if has("<|assistant|>") and has("<|user|>"):
        if has("<|tool_declare|>"):
            return "exaone-moe"
        return "falcon3" if has("</s>") else "glmedge"
    if has("<|user|>") and has("<|endoftext|>"):
        return "zephyr"
    if has("bos_token + message['role']"):
        return "monarch"
    if has("<start_of_turn>"):
        return "gemma"
    if has("'\\n\\nAssistant: ' + eos_token"):
        return "orion"
    if has("GPT4 Correct "):
        return "openchat"
    if has("USER: ") and has("ASSISTANT: "):
        return "vicuna-orca" if has("SYSTEM: ") else "vicuna"
    if has("### Instruction:") and has("<|EOT|>"):
        return "deepseek"
    if has("<|START_OF_TURN_TOKEN|>") and has("<|USER_TOKEN|>"):
        return "command-r"
    if has("<|start_header_id|>") and has("<|end_header_id|>"):
        return "llama3"
    if has("[gMASK]sop"):
        return "chatglm3"
    if has("<用户>"):
        return "minicpm"
    if has("'Assistant: ' + message['content'] + eos_token"):
        return "deepseek2"
    if has("<｜Assistant｜>") and has("<｜User｜>") and has("<｜end▁of▁sentence｜>"):
        return "deepseek3"
    if has("[|system|]") and has("[|assistant|]") and has("[|endofturn|]"):
        return "exaone4" if has("[|tool|]") else "exaone3"
    if has("rwkv-world") or has("{{- 'User: ' + message['content']|trim + '\\n\\n' -}}"):
        return "rwkv-world"
    if has("<|start_of_role|>"):
        return "granite"
    if has("message['role'] + additional_special_tokens[0] + message['content'] + additional_special_tokens[1]"):
        return "gigachat"
    if has("<|role_start|>"):
        return "megrez"
    if has(" Ассистент:"):
        return "yandex"
    if has("<role>ASSISTANT</role>") and has("'HUMAN'"):
        return "bailing"
    if has("<role>ASSISTANT</role>") and has('"HUMAN"') and has("<think>"):
        return "bailing-think"
    if has("<role>ASSISTANT</role>") and has("<role>HUMAN</role>") and has("<|role_end|>"):
        return "bailing2"
    if has("<|header_start|>") and has("<|header_end|>"):
        return "llama4"
    if has("<|endofuserprompt|>"):
        return "dots1"
    if has("<|extra_0|>") and has("<|extra_4|>"):
        return "hunyuan-moe"
    if has("<|start|>") and has("<|channel|>"):
        return "gpt-oss"
    if has("<｜hy_Assistant｜>") and has("<｜hy_place▁holder▁no▁3｜>"):
        return "hunyuan-dense"
    if has("<|im_assistant|>assistant<|im_middle|>"):
        return "kimi-k2"
    if has("<seed:bos>"):
        return "seed-oss"
    if has("'Assistant: '  + message['content'] + '<|separator|>"):
        return "grok-2"
    if has("[unused9]系统：[unused10]"):
        return "pangu"
    if has("<|begin|>") and has("<|end|>") and has("<|content|>"):
        return "solar-open"
    # arch fallbacks when no template is embedded
    if arch.startswith("gemma"):
        return "gemma"
    if arch.startswith("phi"):
        return "phi3"
    if arch.startswith("qwen"):
        return "chatml"
    if arch.startswith("deepseek"):
        return "deepseek3"
    if arch.startswith("rwkv"):
        return "rwkv-world"
    if arch == "gpt-oss":
        return "gpt-oss"
    if arch == "llama":
        return "llama3"
    return "chatml"


def render_jinja(model, messages: list[dict], add_assistant: bool = True,
                 tools: list | None = None) -> str:
    """Evaluate the GGUF's embedded tokenizer.chat_template with a real
    (sandboxed) Jinja engine — the analogue of the reference's --jinja
    mode (common/jinja/ minja evaluation vs llama-chat.cpp's builtin
    formatters).  Raises on a missing/broken template; callers fall back
    to the builtin registry."""
    import json as _json
    from datetime import datetime

    from jinja2 import sandbox

    src = getattr(model, "chat_template", "") or ""
    if not src.strip():
        raise ValueError("model has no embedded chat template")
    env = sandbox.ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)
    env.filters["tojson"] = lambda x, **kw: _json.dumps(x, ensure_ascii=False, **kw)

    def raise_exception(msg):
        raise ValueError(msg)

    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = lambda f: datetime.now().strftime(f)
    tok = getattr(model, "tokenizer", None)
    v = tok.vocab if tok is not None else None

    def _tok_text(tid):
        return v.tokens[tid] if v is not None and 0 <= tid < len(v.tokens) else ""

    return env.from_string(src).render(
        messages=messages,
        add_generation_prompt=add_assistant,
        bos_token=_tok_text(v.bos_id) if v else "",
        eos_token=_tok_text(v.eos_id) if v else "",
        tools=tools,
    )


def apply_chat_template(model, messages: list[dict], fmt: str | None = None,
                        add_assistant: bool = True, jinja: bool = False) -> str:
    if jinja:
        try:
            return render_jinja(model, messages, add_assistant)
        except Exception:  # noqa: BLE001 — broken template: builtin fallback
            pass
    fmt = fmt or detect_format(model)
    formatter = FORMATS.get(fmt)
    if formatter is None:
        return "".join(
            [f"{m['role']}: {m['content']}\n" for m in messages]
            + (["assistant: "] if add_assistant else [])
        )
    out = formatter(messages, add_assistant)
    if fmt == "llama3":
        out = "<|begin_of_text|>" + out
    return out
