// Native EXR IO for liverrenderer.
//
// The reference handles image IO in C++ (src/core/bitmap.cpp, 2562 LoC, via
// ext/openexr).  We do the same with a thin extern-"C"
// bridge over the system OpenEXR that numpy can call through ctypes, reading
// any scanline EXR (PIZ/ZIP/ZIPS/RLE/PXR24/...) into interleaved float32 and
// writing float32 back out with ZIP compression.
//
// Exposed functions (all return 0 on success, negative on failure; error
// text retrievable via lrt_exr_error):
//   lrt_exr_probe(path, &width, &height, &nchan)
//   lrt_exr_channel_name(i, buf, buflen)    -- valid after probe
//   lrt_exr_read(path, out, nfloats)        -- interleaved HxWxC float32,
//                                              channels in file order
//   lrt_exr_write(path, data, w, h, nchan)  -- nchan in {1,3,4}: Y/RGB/RGBA

#include <ImfInputFile.h>
#include <ImfOutputFile.h>
#include <ImfChannelList.h>
#include <ImfFrameBuffer.h>
#include <ImfHeader.h>
#include <ImathBox.h>

#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;
thread_local std::vector<std::string> g_channels;

void set_error(const char* what) { g_error = what ? what : "unknown"; }

}  // namespace

extern "C" {

const char* lrt_exr_error() { return g_error.c_str(); }

int lrt_exr_probe(const char* path, int* width, int* height, int* nchan) {
    try {
        Imf::InputFile file(path);
        const Imath::Box2i dw = file.header().dataWindow();
        *width = dw.max.x - dw.min.x + 1;
        *height = dw.max.y - dw.min.y + 1;
        g_channels.clear();
        const Imf::ChannelList& cl = file.header().channels();
        for (auto it = cl.begin(); it != cl.end(); ++it)
            g_channels.push_back(it.name());
        *nchan = static_cast<int>(g_channels.size());
        return 0;
    } catch (const std::exception& e) {
        set_error(e.what());
        return -1;
    }
}

int lrt_exr_channel_name(int i, char* buf, int buflen) {
    if (i < 0 || i >= static_cast<int>(g_channels.size())) return -1;
    std::snprintf(buf, buflen, "%s", g_channels[i].c_str());
    return 0;
}

int lrt_exr_read(const char* path, float* out, long long nfloats) {
    try {
        Imf::InputFile file(path);
        const Imath::Box2i dw = file.header().dataWindow();
        const int w = dw.max.x - dw.min.x + 1;
        const int h = dw.max.y - dw.min.y + 1;
        const Imf::ChannelList& cl = file.header().channels();
        std::vector<std::string> names;
        for (auto it = cl.begin(); it != cl.end(); ++it)
            names.push_back(it.name());
        const int c = static_cast<int>(names.size());
        if (nfloats != static_cast<long long>(w) * h * c) {
            set_error("output buffer size mismatch");
            return -2;
        }
        Imf::FrameBuffer fb;
        // interleaved float32, shifted so dataWindow min maps to out[0]
        char* base = reinterpret_cast<char*>(out) -
                     (static_cast<long long>(dw.min.y) * w + dw.min.x) *
                         c * sizeof(float);
        for (int i = 0; i < c; ++i)
            fb.insert(names[i],
                      Imf::Slice(Imf::FLOAT, base + i * sizeof(float),
                                 c * sizeof(float),
                                 static_cast<size_t>(c) * w * sizeof(float)));
        file.setFrameBuffer(fb);
        file.readPixels(dw.min.y, dw.max.y);
        return 0;
    } catch (const std::exception& e) {
        set_error(e.what());
        return -1;
    }
}

int lrt_exr_write(const char* path, const float* data, int w, int h,
                  int nchan) {
    try {
        static const char* rgba[4] = {"R", "G", "B", "A"};
        Imf::Header header(w, h);
        header.compression() = Imf::ZIP_COMPRESSION;
        Imf::FrameBuffer fb;
        for (int i = 0; i < nchan; ++i) {
            const char* name = (nchan == 1) ? "Y" : rgba[i];
            header.channels().insert(name, Imf::Channel(Imf::FLOAT));
            fb.insert(name,
                      Imf::Slice(Imf::FLOAT,
                                 const_cast<char*>(
                                     reinterpret_cast<const char*>(data)) +
                                     i * sizeof(float),
                                 static_cast<size_t>(nchan) * sizeof(float),
                                 static_cast<size_t>(nchan) * w *
                                     sizeof(float)));
        }
        Imf::OutputFile file(path, header);
        file.setFrameBuffer(fb);
        file.writePixels(h);
        return 0;
    } catch (const std::exception& e) {
        set_error(e.what());
        return -1;
    }
}

}  // extern "C"
