// dbgtpu_torch native runtime: read parsing + 2-bit packing.
//
// Counterpart of the reference's C++ host runtime
// (Aligner::getReads, aligner.cpp:46-117): parses FASTA/FASTQ with the
// reference's acceptance rules and emits flat arrays ready for numpy /
// device batching — 2-bit codes, N-mask, record offsets, headers.
// Behavior contract is dbgtpu_torch/io/fasta.py (the executable spec); the
// two are parity-tested byte-for-byte.
//
// Build: g++ -O3 -march=native -shared -fPIC io.cpp -o libdbgtpu_torch_io.so
// (driven by dbgtpu_torch/native/__init__.py, cached, with python fallback).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Tables {
    uint8_t code[256];   // A=0 C=1 G=2 else 3
    uint8_t ok[256];     // 1 iff in {A,C,G,T,N}
    uint8_t isn[256];    // 1 iff 'N'
    Tables() {
        memset(code, 3, sizeof(code));
        memset(ok, 0, sizeof(ok));
        memset(isn, 0, sizeof(isn));
        code[(unsigned)'A'] = 0;
        code[(unsigned)'C'] = 1;
        code[(unsigned)'G'] = 2;
        code[(unsigned)'T'] = 3;
        ok[(unsigned)'A'] = ok[(unsigned)'C'] = ok[(unsigned)'G'] =
            ok[(unsigned)'T'] = ok[(unsigned)'N'] = 1;
        isn[(unsigned)'N'] = 1;
    }
};
const Tables T;

struct RecordSink {
    std::vector<uint8_t> codes, nmask, headers;
    std::vector<int64_t> seq_off{0}, hdr_off{0};
    // in-progress record state
    int64_t rec_seq_start = 0, rec_hdr_start = 0;
    bool rec_valid = true;
    bool rec_open = false;

    void open_record(const char* hdr, size_t hlen) {
        rec_seq_start = (int64_t)codes.size();
        rec_hdr_start = (int64_t)headers.size();
        headers.insert(headers.end(), hdr, hdr + hlen);
        rec_valid = true;
        rec_open = true;
    }
    void add_seq(const char* s, size_t n) {
        for (size_t i = 0; i < n; ++i) {
            unsigned c = (unsigned char)s[i];
            if (!T.ok[c]) rec_valid = false;
            codes.push_back(T.code[c]);
            nmask.push_back(T.isn[c]);
        }
    }
    // close; keep iff valid && len > 2 && len > min_len
    void close_record(int64_t min_len) {
        if (!rec_open) return;
        int64_t len = (int64_t)codes.size() - rec_seq_start;
        if (rec_valid && len > 2 && len > min_len) {
            seq_off.push_back((int64_t)codes.size());
            hdr_off.push_back((int64_t)headers.size());
        } else {
            codes.resize(rec_seq_start);
            nmask.resize(rec_seq_start);
            headers.resize(rec_hdr_start);
        }
        rec_open = false;
    }
};

// Split buf into newline-terminated lines (last line may lack \n);
// calls fn(line_start, line_len_without_newline).
template <class F>
void for_lines(const char* buf, size_t n, F fn) {
    size_t i = 0;
    while (i < n) {
        const char* nl = (const char*)memchr(buf + i, '\n', n - i);
        size_t len = nl ? (size_t)(nl - (buf + i)) : n - i;
        fn(buf + i, len);
        i += len + (nl ? 1 : 0);
        if (!nl) break;
    }
}

}  // namespace

extern "C" {

struct Parsed {
    int64_t n;          // accepted records
    int64_t seq_bytes;  // total sequence length
    int64_t hdr_bytes;
    uint8_t* codes;     // [seq_bytes]
    uint8_t* nmask;     // [seq_bytes]
    int64_t* seq_off;   // [n+1]
    uint8_t* headers;   // [hdr_bytes] concatenated header lines (no \n)
    int64_t* hdr_off;   // [n+1]
};

static Parsed* finish(RecordSink& b) {
    Parsed* p = (Parsed*)malloc(sizeof(Parsed));
    p->n = (int64_t)b.seq_off.size() - 1;
    p->seq_bytes = (int64_t)b.codes.size();
    p->hdr_bytes = (int64_t)b.headers.size();
    p->codes = (uint8_t*)malloc(b.codes.size() ? b.codes.size() : 1);
    p->nmask = (uint8_t*)malloc(b.nmask.size() ? b.nmask.size() : 1);
    p->headers = (uint8_t*)malloc(b.headers.size() ? b.headers.size() : 1);
    p->seq_off = (int64_t*)malloc(b.seq_off.size() * sizeof(int64_t));
    p->hdr_off = (int64_t*)malloc(b.hdr_off.size() * sizeof(int64_t));
    memcpy(p->codes, b.codes.data(), b.codes.size());
    memcpy(p->nmask, b.nmask.data(), b.nmask.size());
    memcpy(p->headers, b.headers.data(), b.headers.size());
    memcpy(p->seq_off, b.seq_off.data(), b.seq_off.size() * sizeof(int64_t));
    memcpy(p->hdr_off, b.hdr_off.data(), b.hdr_off.size() * sizeof(int64_t));
    return p;
}

// Parse a read file.  fastq=0: FASTA — records joined across lines,
// accepted iff charset ok && len>2 && len>k.  fastq=1: 4-line FASTQ —
// accepted iff charset ok && len>2 (no len>k rule, matching the
// reference; its last-record duplication defect is NOT replicated).
Parsed* dbg_parse_reads(const char* path, int64_t k, int32_t fastq) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long fsz = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf((size_t)fsz);
    if (fsz && fread(buf.data(), 1, (size_t)fsz, f) != (size_t)fsz) {
        fclose(f);
        return nullptr;
    }
    fclose(f);

    RecordSink b;
    if (!fastq) {
        for_lines(buf.data(), buf.size(), [&](const char* s, size_t len) {
            if (len > 0 && s[0] == '>') {
                b.close_record(k);
                b.open_record(s, len);
            } else if (b.rec_open) {
                b.add_seq(s, len);
            }
        });
        b.close_record(k);
    } else {
        // 4-line records; a truncated trailing record (missing '+' or
        // qual line) still yields its sequence, then parsing stops.
        size_t i = 0, n = buf.size();
        auto next_line = [&](const char*& s, size_t& len) -> bool {
            if (i >= n) return false;
            const char* nl = (const char*)memchr(buf.data() + i, '\n', n - i);
            s = buf.data() + i;
            len = nl ? (size_t)(nl - s) : n - i;
            i += len + (nl ? 1 : 0);
            return true;
        };
        for (;;) {
            const char *h, *s, *pl, *q;
            size_t hl, sl, pll, ql;
            if (!next_line(h, hl)) break;
            if (!next_line(s, sl)) { s = nullptr; sl = 0; }
            bool have_plus = next_line(pl, pll);
            bool have_qual = next_line(q, ql);
            b.open_record(h, hl);
            if (s) b.add_seq(s, sl);
            b.close_record(2);  // len > 2 only (no k rule in fastq)
            if (!have_plus || !have_qual) break;
        }
    }
    return finish(b);
}

void dbg_free_parsed(Parsed* p) {
    if (!p) return;
    free(p->codes);
    free(p->nmask);
    free(p->headers);
    free(p->seq_off);
    free(p->hdr_off);
    free(p);
}

// ---------------------------------------------------------------- writer

// Format the paths file: per aligned read, header line + newline +
// "v." joined path + newline (reference printPath, aligner.cpp:600-609).
// paths_flat holds each read's path values back to back (path_off[i] ..
// path_off[i+1]); reads with status not in {1,2} are skipped.
// Returns malloc'd buffer; *out_len receives its length.
uint8_t* dbg_format_paths(
    const uint8_t* headers, const int64_t* hdr_off,
    const int32_t* status, const int64_t* path_off,
    const int32_t* paths_flat, int64_t n, int64_t* out_len) {
    std::vector<uint8_t> out;
    out.reserve((size_t)n * 32);
    char tmp[16];
    for (int64_t i = 0; i < n; ++i) {
        if (status[i] != 1 && status[i] != 2) continue;
        out.insert(out.end(), headers + hdr_off[i], headers + hdr_off[i + 1]);
        out.push_back('\n');
        for (int64_t j = path_off[i]; j < path_off[i + 1]; ++j) {
            int len = snprintf(tmp, sizeof(tmp), "%d.", paths_flat[j]);
            out.insert(out.end(), tmp, tmp + len);
        }
        out.push_back('\n');
    }
    uint8_t* res = (uint8_t*)malloc(out.size() ? out.size() : 1);
    memcpy(res, out.data(), out.size());
    *out_len = (int64_t)out.size();
    return res;
}

// Format the notAligned file: per NON-aligned read (status not 1/2),
// header line + newline + original sequence chars + newline (reference
// notAligned.fa writes, alignerGreedy.cpp:400-427; receives both
// no-overlap and overlap-but-unaligned reads, SURVEY.md §4.1 item 3).
// `chars` is the whole file's ASCII base stream (N restored).
uint8_t* dbg_format_notaligned(
    const uint8_t* headers, const int64_t* hdr_off,
    const int32_t* status, const uint8_t* chars,
    const int64_t* seq_off, int64_t n, int64_t* out_len) {
    std::vector<uint8_t> out;
    out.reserve((size_t)n * 16);
    for (int64_t i = 0; i < n; ++i) {
        if (status[i] == 1 || status[i] == 2) continue;
        out.insert(out.end(), headers + hdr_off[i], headers + hdr_off[i + 1]);
        out.push_back('\n');
        out.insert(out.end(), chars + seq_off[i], chars + seq_off[i + 1]);
        out.push_back('\n');
    }
    uint8_t* res = (uint8_t*)malloc(out.size() ? out.size() : 1);
    memcpy(res, out.data(), out.size());
    *out_len = (int64_t)out.size();
    return res;
}

// Correction mode (-c): per aligned read, header + the genomic
// sequence recovered along its path + newline (reference recoverPath,
// aligner.cpp:270-290: splice unitigs with k-1 overlaps, slice
// [offset, offset+readLen), RC back when the read aligned as RC —
// alignerGreedy.cpp:394-399).  `pool` holds 2-bit codes of all unitigs
// back to back (uoff/ulen index it, ids 1-based, negative = RC).
uint8_t* dbg_format_corrected(
    const uint8_t* headers, const int64_t* hdr_off,
    const int32_t* status, const int64_t* path_off, const int32_t* flat,
    const int64_t* seq_off,
    const uint8_t* pool, const int32_t* uoff, const int32_t* ulen,
    int32_t k, int64_t n, int64_t* out_len) {
    static const char ACGT[] = "ACGT";
    std::vector<uint8_t> out;
    out.reserve((size_t)n * 64);
    std::vector<uint8_t> tmp;
    for (int64_t i = 0; i < n; ++i) {
        if (status[i] != 1 && status[i] != 2) continue;
        int64_t rlen = seq_off[i + 1] - seq_off[i];
        const int32_t* p = flat + path_off[i];
        int64_t m = path_off[i + 1] - path_off[i];
        if (m < 2) continue;
        int64_t offset = p[0];
        tmp.clear();
        for (int64_t j = 1; j < m; ++j) {
            int32_t sid = p[j];
            int32_t id = sid < 0 ? -sid : sid;
            int32_t len = ulen[id];
            const uint8_t* base = pool + uoff[id];
            int64_t start = (j == 1) ? 0 : (k - 1);
            for (int64_t t = start; t < len; ++t)
                tmp.push_back(sid > 0 ? base[t]
                                      : (uint8_t)(3 - base[len - 1 - t]));
            if ((int64_t)tmp.size() >= offset + rlen) break;
        }
        out.insert(out.end(), headers + hdr_off[i], headers + hdr_off[i + 1]);
        out.push_back('\n');
        int64_t avail = (int64_t)tmp.size() - offset;
        int64_t w = rlen < avail ? rlen : avail;   // defensive clamp
        if (status[i] == 1) {
            for (int64_t t = 0; t < w; ++t)
                out.push_back((uint8_t)ACGT[tmp[offset + t]]);
        } else {
            for (int64_t t = 0; t < w; ++t)
                out.push_back((uint8_t)ACGT[3 - tmp[offset + w - 1 - t]]);
        }
        out.push_back('\n');
    }
    uint8_t* res = (uint8_t*)malloc(out.size() ? out.size() : 1);
    memcpy(res, out.data(), out.size());
    *out_len = (int64_t)out.size();
    return res;
}

// Pack a batch of parsed records straight into the device H2D layout
// (engine.runner pack_words_batch semantics): records [s0, s0+nb) of
// the flat code/nmask streams, padded to B rows x L bases, emitted as
// 2-bit words (base j at bits 2*(j%16) of word j/16) and 1-bit N-mask
// words.  Caller provides zeroed outputs: words [B, (L+15)/16],
// nmbits [B, (L+31)/32], lens [B].
void dbg_pack_batch(
    const uint8_t* codes, const uint8_t* nmask, const int64_t* seq_off,
    int64_t s0, int64_t nb, int64_t L,
    uint32_t* words, uint32_t* nmbits, int32_t* lens_out) {
    int64_t Lw = (L + 15) / 16, Lb = (L + 31) / 32;
    for (int64_t i = 0; i < nb; ++i) {
        int64_t off = seq_off[s0 + i];
        int64_t n = seq_off[s0 + i + 1] - off;
        if (n > L) n = L;
        lens_out[i] = (int32_t)n;
        uint32_t* w = words + i * Lw;
        uint32_t* nm = nmbits + i * Lb;
        const uint8_t* c = codes + off;
        const uint8_t* q = nmask + off;
        for (int64_t j = 0; j < n; ++j) {
            w[j >> 4] |= (uint32_t)(c[j] & 3) << (2 * (j & 15));
            if (q[j]) nm[j >> 5] |= (uint32_t)1 << (j & 31);
        }
    }
}

void dbg_free_buf(uint8_t* p) { free(p); }

}  // extern "C"
