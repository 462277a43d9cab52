// The port's native library: native.cpp (a pinned copy of the JAX
// package's, held equal to it) plus one exported entry, the per-word
// English stemmer that native.cpp keeps static for its inverter. The
// port's loader (native/__init__.py) compiles this file alone, so every
// symbol of native.cpp is in the same library.
#include "native.cpp"

// Porter2 stem of one lowercase word (native.cpp xtinv::stem_english, the
// inverter's stemmer). Writes at most cap bytes to out and returns the
// stem's length, or -1 when it does not fit.
extern "C" int64_t xt_stem_english(const char* w, int64_t n, char* out,
                                   int64_t cap) {
    const std::string s = xtinv::stem_english(std::string(w, (size_t)n));
    if ((int64_t)s.size() > cap) return -1;
    std::memcpy(out, s.data(), s.size());
    return (int64_t)s.size();
}
