// Native ingest library: cross-file byte-stream splicing + PRT packet parsing.
//
// TPU-native equivalent of the reference's L0/L1 layer — the one component
// the reference itself deliberately models on a C++ file-reader class
// (read_continuous_file_stream.m:2 "模拟 C++ 类的行为"; FrameDataRead_xzr.m).
// Python binds via ctypes (see native_loader.py); output buffers are
// caller-allocated NumPy arrays (complex64 as interleaved float32).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libingest.so ingest.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct FileStream {
    std::string root;
    std::string pattern;  // printf pattern with one %d field
    int file_index = 0;   // last opened index
    FILE* fh = nullptr;
    int64_t remaining = 0;

    bool open_next() {
        // commit the index only on success so retries after transient EOS
        // re-attempt the same file instead of skipping ahead
        const int next = file_index + 1;
        char name[64];
        std::snprintf(name, sizeof(name), pattern.c_str(), next);
        std::string path = root + "/" + name;
        fh = std::fopen(path.c_str(), "rb");
        if (!fh) return false;
        file_index = next;
        std::fseek(fh, 0, SEEK_END);
        remaining = std::ftell(fh);
        std::fseek(fh, 0, SEEK_SET);
        return true;
    }

    // Read exactly n bytes across file boundaries; returns actual count.
    int64_t read(uint8_t* buf, int64_t n) {
        int64_t got = 0;
        while (got < n) {
            if (!fh) {
                if (!open_next()) return got;  // stream exhausted
            }
            int64_t want = n - got;
            if (want > remaining) want = remaining;
            size_t r = std::fread(buf + got, 1, (size_t)want, fh);
            got += (int64_t)r;
            remaining -= (int64_t)r;
            if (remaining <= 0 || r == 0) {
                std::fclose(fh);
                fh = nullptr;
                if (r == 0 && remaining > 0) return got;  // short read
            }
        }
        return got;
    }

    ~FileStream() {
        if (fh) std::fclose(fh);
    }
};

inline int32_t sign24(uint32_t v) {
    // MATLAB parity: the reference subtracts 2^24 only for values strictly
    // greater than 2^23 (FrameDataRead_xzr.m:135-136), so 0x800000 itself
    // stays positive.
    return (v > 0x800000u) ? (int32_t)v - 0x1000000 : (int32_t)v;
}

struct G2Reader {
    FileStream stream;
    int n_prt, point_prt, n_channels;
    int bytes_head, bytes_realtime, bytes_tail;
    int current_prt = 0;
    int last_frame_idx = -1;
    // staging for the two-phase (read | convert) parse
    std::vector<uint8_t> staging;
    std::vector<int> prt_data_type;
    std::vector<int> prt_pad1;
};

// Convert one PRT payload into interleaved float32 I/Q.
void convert_prt(const uint8_t* buf, float* out, int pts, int ch,
                 int data_type, int pad1) {
    if (data_type == 0) {
        const int16_t* d = reinterpret_cast<const int16_t*>(buf);
        const int n = pts * ch;
        for (int i = 0; i < n; ++i) {
            out[i * 2] = (float)d[i];
            out[i * 2 + 1] = 0.f;
        }
    } else if (data_type == 1) {
        const int16_t* d = reinterpret_cast<const int16_t*>(buf);
        const int n = pts * ch * 2;  // single linear pass: auto-vectorizes
        for (int i = 0; i < n; ++i) out[i] = (float)d[i];
    } else {
        const int row = ch * 6 + pad1;
        for (int s = 0; s < pts; ++s) {
            const uint8_t* p = buf + (size_t)s * row;
            for (int c = 0; c < ch; ++c) {
                uint32_t vi = (uint32_t)p[c * 6] | ((uint32_t)p[c * 6 + 1] << 8) |
                              ((uint32_t)p[c * 6 + 2] << 16);
                uint32_t vq = (uint32_t)p[c * 6 + 3] | ((uint32_t)p[c * 6 + 4] << 8) |
                              ((uint32_t)p[c * 6 + 5] << 16);
                out[((size_t)s * ch + c) * 2] = (float)sign24(vi);
                out[((size_t)s * ch + c) * 2 + 1] = (float)sign24(vq);
            }
        }
    }
}

}  // namespace

extern "C" {

// ----------------------------------------------------------------- stream API
void* rsp_stream_open(const char* root, const char* pattern, int start_index) {
    auto* s = new FileStream();
    s->root = root;
    s->pattern = pattern;
    s->file_index = start_index - 1;
    return s;
}

int64_t rsp_stream_read(void* h, uint8_t* buf, int64_t n) {
    return static_cast<FileStream*>(h)->read(buf, n);
}

void rsp_stream_close(void* h) { delete static_cast<FileStream*>(h); }

// --------------------------------------------------------------- G2 frame API
void* rsp_g2_open(const char* root, const char* pattern, int n_prt,
                  int point_prt, int n_channels, int bytes_head,
                  int bytes_realtime, int bytes_tail) {
    auto* r = new G2Reader();
    r->stream.root = root;
    r->stream.pattern = pattern;
    r->n_prt = n_prt;
    r->point_prt = point_prt;
    r->n_channels = n_channels;
    r->bytes_head = bytes_head;
    r->bytes_realtime = bytes_realtime;
    r->bytes_tail = bytes_tail;
    return r;
}

// Parse one frame. iq: interleaved float32 (n_prt, point_prt, n_channels, 2),
// angles: double(n_prt). Returns 1 when the frame completed, 0 otherwise;
// *eos set when the underlying stream ended / header was corrupt.
// Mid-frame resume: calling again with the same frame_idx continues at the
// internal PRT cursor (FrameDataRead_xzr.m:49-52 semantics).
int rsp_g2_read_frame(void* h, int frame_idx, float* iq, double* angles,
                      int* prts_read, int* eos) {
    auto* r = static_cast<G2Reader*>(h);
    *eos = 0;
    if (r->last_frame_idx != frame_idx) {
        r->current_prt = 0;
        r->last_frame_idx = frame_idx;
    }
    const int pts = r->point_prt, ch = r->n_channels;
    // scratch buffers
    static thread_local std::string scratch;
    uint8_t head[256];

    while (r->current_prt < r->n_prt) {
        if (r->stream.read(head, r->bytes_head) < r->bytes_head) {
            *eos = 1;
            *prts_read = r->current_prt;
            return 0;
        }
        uint32_t h32[16];
        std::memcpy(h32, head, sizeof(h32));
        const int32_t pulse_data_num = (int32_t)h32[6];
        const int channel_num = (int)(h32[3] & 0xFFu);
        const int data_type = (int)(h32[7] & 0xFFu);
        const int servo = (int)(h32[4] & 0xFFFFu);
        if (pulse_data_num <= 0) {  // corrupted header
            *eos = 1;
            *prts_read = r->current_prt;
            return 0;
        }

        uint8_t rt[512];
        if (r->stream.read(rt, r->bytes_realtime) < r->bytes_realtime) {
            *eos = 1;
            *prts_read = r->current_prt;
            return 0;
        }

        // payload size (FrameDataRead_xzr.m:105-119)
        int64_t size;
        int pad1 = 0;
        if (data_type == 0) {
            size = (int64_t)pulse_data_num * channel_num * 2;
        } else if (data_type == 1) {
            size = (int64_t)pulse_data_num * channel_num * 4;
        } else {
            pad1 = 8 - (6 * channel_num) % 8;
            size = (int64_t)pulse_data_num * (channel_num * 6 + pad1);
        }
        if (size % 64) size += 64 - size % 64;

        scratch.resize((size_t)size);
        auto* buf = reinterpret_cast<uint8_t*>(&scratch[0]);
        if (r->stream.read(buf, size) < size) {
            *eos = 1;
            *prts_read = r->current_prt;
            return 0;
        }
        if (pulse_data_num != pts || channel_num != ch) {  // dim mismatch
            *eos = 1;
            *prts_read = r->current_prt;
            return 0;
        }

        float* out = iq + (size_t)r->current_prt * pts * ch * 2;
        convert_prt(buf, out, pts, ch, data_type, pad1);
        angles[r->current_prt] = (double)servo;
        ++r->current_prt;

        uint8_t tail[256];
        if (r->stream.read(tail, r->bytes_tail) < r->bytes_tail) {
            *eos = 1;
            *prts_read = r->current_prt;
            return 0;
        }
    }
    *prts_read = r->current_prt;
    return 1;
}

// Two-phase parse: stage every PRT payload sequentially (the byte stream is
// stateful), then convert payloads to float across `n_threads` workers.  The
// int16->float conversion is the memory-bound half of ingest, so splitting
// PRT ranges across cores overlaps it with nothing else contending.
// Same contract and mid-frame-resume semantics as rsp_g2_read_frame.
int rsp_g2_read_frame_mt(void* h, int frame_idx, float* iq, double* angles,
                         int* prts_read, int* eos, int n_threads) {
    auto* r = static_cast<G2Reader*>(h);
    *eos = 0;
    if (r->last_frame_idx != frame_idx) {
        r->current_prt = 0;
        r->last_frame_idx = frame_idx;
    }
    const int pts = r->point_prt, ch = r->n_channels;
    const int first_prt = r->current_prt;
    uint8_t head[256];

    r->staging.clear();
    r->prt_data_type.assign(r->n_prt, -1);
    r->prt_pad1.assign(r->n_prt, 0);
    std::vector<size_t> offsets(r->n_prt, 0);
    int status = 1;

    while (r->current_prt < r->n_prt) {
        if (r->stream.read(head, r->bytes_head) < r->bytes_head) {
            *eos = 1; status = 0; break;
        }
        uint32_t h32[16];
        std::memcpy(h32, head, sizeof(h32));
        const int32_t pulse_data_num = (int32_t)h32[6];
        const int channel_num = (int)(h32[3] & 0xFFu);
        const int data_type = (int)(h32[7] & 0xFFu);
        const int servo = (int)(h32[4] & 0xFFFFu);
        if (pulse_data_num <= 0) { *eos = 1; status = 0; break; }

        uint8_t rt[512];
        if (r->stream.read(rt, r->bytes_realtime) < r->bytes_realtime) {
            *eos = 1; status = 0; break;
        }

        int64_t size;
        int pad1 = 0;
        if (data_type == 0) {
            size = (int64_t)pulse_data_num * channel_num * 2;
        } else if (data_type == 1) {
            size = (int64_t)pulse_data_num * channel_num * 4;
        } else {
            pad1 = 8 - (6 * channel_num) % 8;
            size = (int64_t)pulse_data_num * (channel_num * 6 + pad1);
        }
        if (size % 64) size += 64 - size % 64;

        const size_t off = r->staging.size();
        r->staging.resize(off + (size_t)size);
        if (r->stream.read(&r->staging[off], size) < size) {
            *eos = 1; status = 0; break;
        }
        if (pulse_data_num != pts || channel_num != ch) {
            *eos = 1; status = 0; break;
        }
        offsets[r->current_prt] = off;
        r->prt_data_type[r->current_prt] = data_type;
        r->prt_pad1[r->current_prt] = pad1;
        angles[r->current_prt] = (double)servo;
        ++r->current_prt;

        uint8_t tail[256];
        if (r->stream.read(tail, r->bytes_tail) < r->bytes_tail) {
            *eos = 1; status = 0; break;
        }
    }

    // convert whatever was staged (also on early EOS, so resume semantics
    // match the single-threaded parser)
    const int last_prt = r->current_prt;
    const int n_staged = last_prt - first_prt;
    if (n_staged > 0) {
        int workers = n_threads < 1 ? 1 : n_threads;
        if (workers > n_staged) workers = n_staged;
        auto work = [&](int w) {
            const int lo = first_prt + (int)((int64_t)n_staged * w / workers);
            const int hi = first_prt + (int)((int64_t)n_staged * (w + 1) / workers);
            for (int p = lo; p < hi; ++p) {
                convert_prt(&r->staging[offsets[p]],
                            iq + (size_t)p * pts * ch * 2, pts, ch,
                            r->prt_data_type[p], r->prt_pad1[p]);
            }
        };
        if (workers == 1) {
            work(0);
        } else {
            std::vector<std::thread> threads;
            threads.reserve(workers);
            for (int w = 0; w < workers; ++w) threads.emplace_back(work, w);
            for (auto& t : threads) t.join();
        }
    }
    *prts_read = r->current_prt;
    return status;
}

void rsp_g2_close(void* h) { delete static_cast<G2Reader*>(h); }

// --------------------------------------------------------------- G1 frame API
// Parse one G1 frame from `path` at byte `offset`.
// left/right: interleaved float32 (n_prt, point_prt, 2); angles: double(n_prt).
// Returns 0 on success, -1 open failure, -2 truncated, -3 bad sync.
int rsp_g1_read_frame(const char* path, int64_t offset, int n_prt,
                      int point_prt, float* left, float* right,
                      double* angles, int32_t* meta /* [6] */) {
    FILE* fh = std::fopen(path, "rb");
    if (!fh) return -1;
    std::fseek(fh, (long)offset, SEEK_SET);
    const int payload = 12 * point_prt;
    std::string buf;
    buf.resize((size_t)payload);
    uint8_t head[28];
    for (int i = 0; i < n_prt; ++i) {
        if (std::fread(head, 1, 28, fh) < 28) { std::fclose(fh); return -2; }
        uint16_t h16[8];
        std::memcpy(h16, head, sizeof(h16));
        if (h16[0] != 0xA5A5 || h16[1] != 0xA5A5) { std::fclose(fh); return -3; }
        if (meta) {
            meta[0] = (int32_t)((uint32_t)h16[2] << 16 | h16[3]);  // frame no
            meta[1] = h16[4];                                      // mod flag
            meta[2] = head[10];                                    // beam pos
            meta[3] = head[11];                                    // beam nums
            meta[4] = h16[6];                                      // freq index
            meta[5] = h16[7];                                      // prt no
        }
        angles[i] = ((double)head[26] + (double)head[27] * 128.0) * 360.0 / 16384.0;

        auto* b = reinterpret_cast<uint8_t*>(&buf[0]);
        if ((int)std::fread(b, 1, payload, fh) < payload) {
            std::fclose(fh);
            return -2;
        }
        float* lo = left + (size_t)i * point_prt * 2;
        float* ro = right + (size_t)i * point_prt * 2;
        for (int s = 0; s < point_prt; ++s) {
            const uint8_t* p = b + s * 12;
            // byte positions per frameDataRead_A_xzr.m:86-104 (0-based)
            int32_t il = sign24(((uint32_t)p[1] << 16) | ((uint32_t)p[5] << 8) | p[9]);
            int32_t ql = sign24(((uint32_t)p[0] << 16) | ((uint32_t)p[4] << 8) | p[8]);
            int32_t ir = sign24(((uint32_t)p[3] << 16) | ((uint32_t)p[7] << 8) | p[11]);
            int32_t qr = sign24(((uint32_t)p[2] << 16) | ((uint32_t)p[6] << 8) | p[10]);
            lo[s * 2] = (float)il;
            lo[s * 2 + 1] = (float)ql;
            ro[s * 2] = (float)ir;
            ro[s * 2 + 1] = (float)qr;
        }
        std::fseek(fh, 8, SEEK_CUR);
    }
    std::fclose(fh);
    return 0;
}

}  // extern "C"
