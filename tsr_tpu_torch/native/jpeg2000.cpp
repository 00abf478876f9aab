// jpeg2000.cpp — JPEG 2000 (the JP2 file and the raw codestream) as
// cv2.imread reads it (OpenCV 5's Jpeg2KOpjDecoder over OpenJPEG 2.5's
// opj_decode) and as PIL's Jpeg2KImagePlugin and convert("RGB") read it
// (Jpeg2KDecode.c over OpenJPEG's tile API):
//
// - the JP2 boxes that reach the codestream and its colour (jP, ftyp,
//   jp2h with ihdr, colr, bpcc, pclr, cmap and cdef, jp2c), by
//   opj_jp2_read_header's rules; the raw codestream;
// - the main and tile-part headers (SIZ, COD, COC, QCD, QCC, RGN, POC, PPM,
//   PPT, COM, TLM, PLM, PLT, CRG, SOT/SOD, EOC) and the tile-part stream by
//   opj_j2k_read_header_procedure / opj_j2k_read_tile_header /
//   opj_j2k_decode_tiles, with their refusals;
// - Part 2's multi-component markers as OpenJPEG keeps them: CBD's depths
//   and signs, the MCT arrays and MCC collections of the main header and
//   each tile, and an MCO stage's offset array as the tile's DC level
//   shifts (its decorrelation matrix is checked and never applied: COD's
//   MCT byte is 0 or 1);
// - tier 2 (tag trees, packet headers over quality layers, SOP and EPH,
//   headers gathered from PPM or PPT markers) in the five progression
//   orders and their POC changes, default and custom precincts;
// - tier 1 (the MQ decoder, the raw decoder of the bypass mode and the
//   three coding passes under every code-block style: BYPASS, RESET,
//   TERMALL, VSC, PTERM, SEGSYM) with OpenJPEG's half-step reconstruction
//   and its max-shift ROI scaling; HTJ2K's HT code-blocks (ITU-T T.814:
//   the cleanup pass's MEL, VLC, UVLC and MagSgn streams, the SigProp and
//   MagRef passes) by opj_t1_ht_decode_cblk, the CAP and CPF markers read
//   and left aside as OpenJPEG leaves them;
// - dequantisation (none, scalar derived, scalar expounded), the inverse
//   5/3 in integers and the inverse 9/7 in float with OpenJPEG's constants
//   and order of operations, RCT and ICT, and the DC level shift with
//   lrintf and the clamp;
// - the colour boxes as opj_jp2_decode applies them (opj_jp2_check_color,
//   opj_jp2_apply_pclr, opj_jp2_apply_cdef) and each reader's colour
//   space: cv2's sRGB, gray and sYCC (its own COLOR_YUV2BGR), Pillow's
//   unpackers (P and PA through its palette, sYCC, CMYK through cmyk2rgb).
//
// What the port leaves out raises naming JPEG 2000 (kJpeg2000): sub-sampled
// components (ROADMAP 8d). Partial decodes (8g) are not offered,
// except where an HT code-block's own rules stop its refinement passes and
// the decode goes on, as OpenJPEG's does.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <map>
#include <memory>
#include <vector>

#include "codec.h"
#include "ht_tables.h"

namespace tsrio {
namespace {

struct Fail {};         // OpenJPEG fails: the reader gives None / raises
struct Unsupported {};  // a feature the port leaves out (kJpeg2000)

[[noreturn]] void fail() { throw Fail{}; }
[[noreturn]] void unsupported() { throw Unsupported{}; }

uint32_t be16(const uint8_t* p) { return uint32_t{p[0]} << 8 | p[1]; }
uint32_t be32(const uint8_t* p) {
  return uint32_t{p[0]} << 24 | uint32_t{p[1]} << 16 | uint32_t{p[2]} << 8 |
         p[3];
}

int ceildivpow2(int64_t a, int b) {
  return static_cast<int>((a + (int64_t{1} << b) - 1) >> b);
}
int floordivpow2(int a, int b) { return a >> b; }
int floorlog2(uint32_t a) {
  int l = 0;
  while (a > 1) {
    a >>= 1;
    l++;
  }
  return l;
}

// OpenJPEG's stream over the file's bytes: reads past the end come short.
struct Stream {
  const uint8_t* d;
  size_t n, pos = 0;
  size_t left() const { return n - pos; }
  bool read(uint8_t* out, size_t k) {
    if (left() < k) {
      pos = n;
      return false;
    }
    std::memcpy(out, d + pos, k);
    pos += k;
    return true;
  }
  bool read16(uint32_t& v) {
    uint8_t b[2];
    if (!read(b, 2)) return false;
    v = be16(b);
    return true;
  }
};

// ------------------------------------------------------------ JP2 boxes

// opj_image_t's colour spaces (OPJ_CLRSPC_*), from the colr box's EnumCS
enum ColorSpace { kCsUnknown = -1, kCsUnspecified = 0, kCsSrgb = 1, kCsGray = 2,
                  kCsSycc = 3, kCsEycc = 4, kCsCmyk = 5 };

// The pclr box (opj_jp2_pclr_t) and its cmap entries, as read.
struct Palette {
  int ne = 0, npc = 0;
  std::vector<uint32_t> entries;  // ne rows of npc values
  bool has_cmap = false;
  struct Map {
    uint32_t cmp = 0;
    uint8_t mtyp = 0, pcol = 0;
  };
  std::vector<Map> cmap;  // npc entries
};

// A cdef entry (opj_jp2_cdef_info_t).
struct ChannelDef {
  uint32_t cn = 0, typ = 0, asoc = 0;
};

struct Jp2Info {
  bool jp2 = false, has_jp2h = false;
  size_t codestream = 0;  // where the codestream starts
  uint32_t w = 0, h = 0, nc = 0, bpc = 0;
  uint32_t enumcs = 0;
  bool has_colr = false;
  bool has_pclr = false;
  Palette pclr;
  bool has_cdef = false;
  std::vector<ChannelDef> cdef;
};

// opj_jp2_read_header_procedure with the handlers of the JP2 header boxes
// (jP, ftyp, jp2h: ihdr, colr, bpcc, pclr, cmap, cdef): up to the jp2c box
// (`after` false), or over the boxes that follow the codestream
// (opj_jp2_end_decompress, `after` true).
class Jp2Boxes {
 public:
  explicit Jp2Boxes(Jp2Info& info) : info_(info) {}

  void walk(const uint8_t* d, size_t n, size_t pos, bool after) {
    for (;;) {
      if (n - pos < 8) return;  // no box header: the walk ends
      uint64_t len = be32(d + pos);
      const uint32_t type = be32(d + pos + 4);
      uint32_t hlen = 8;
      if (len == 1) {
        if (n - pos < 16 || be32(d + pos + 8) != 0) return;
        len = be32(d + pos + 12);
        hlen = 16;
      }
      pos += hlen;
      if (len == 0) len = 8 + (n - pos);  // the last box: to the end
      if (type == kJp2c) {
        if (!(state_ & kHeader)) fail();  // "bad placed jpeg codestream"
        if (!after) info_.codestream = pos;
        return;
      }
      if (len < hlen) fail();  // "invalid box size"
      const uint64_t size = len - hlen;
      const bool main = type == kJp || type == kFtyp || type == kJp2h;
      if (main || img_box_type(type)) {
        if (!main && !(state_ & kHeader)) {  // misplaced before jp2h: skipped
          if (size > n - pos) fail();
          pos += size;
          state_ |= kUnknown;
          continue;
        }
        if (size > n - pos) fail();  // "Invalid box size"
        const uint8_t* p = d + pos;
        if (type == kJp) {
          if (state_ != 0) fail();
          if (size != 4 || be32(p) != 0x0d0a870a) fail();
          state_ |= kSig;
        } else if (type == kFtyp) {
          if (state_ != kSig) fail();
          if (size < 8 || (size - 8) % 4 != 0) fail();
          state_ |= kFtypState;
        } else if (type == kJp2h) {
          read_jp2h(p, size);
        } else {
          img_box(type, p, static_cast<uint32_t>(size));
        }
        pos += size;
      } else {
        if (!(state_ & kSig) || !(state_ & kFtypState)) fail();
        state_ |= kUnknown;
        if (size > n - pos) {
          if (after) return;  // the skip fails past the codestream
          fail();
        }
        pos += size;
      }
    }
  }

 private:
  // JP2_STATE_*: a box skipped (unknown, or misplaced before jp2h) sets
  // every bit, JP2_STATE_UNKNOWN, so that header boxes found after it
  // outside jp2h are read
  enum { kSig = 1, kFtypState = 2, kHeader = 4, kUnknown = 0x7fffffff };
  static constexpr uint32_t kJp = 0x6a502020, kFtyp = 0x66747970,
      kJp2h = 0x6a703268, kJp2c = 0x6a703263, kIhdr = 0x69686472,
      kColr = 0x636f6c72, kBpcc = 0x62706363, kPclr = 0x70636c72,
      kCmap = 0x636d6170, kCdef = 0x63646566;

  static bool img_box_type(uint32_t t) {
    return t == kIhdr || t == kColr || t == kBpcc || t == kPclr ||
           t == kCmap || t == kCdef;
  }

  void read_jp2h(const uint8_t* p, uint64_t size) {
    if ((state_ & kFtypState) != kFtypState) fail();
    bool has_ihdr = false;
    while (size > 0) {
      if (size < 8) fail();
      uint64_t blen = be32(p);
      const uint32_t btype = be32(p + 4);
      uint32_t bh = 8;
      if (blen == 1) {
        if (size < 16 || be32(p + 8) != 0) fail();
        blen = be32(p + 12);
        bh = 16;
      }
      if (blen == 0 || blen < bh || blen > size) fail();
      if (img_box_type(btype)) img_box(btype, p + bh, static_cast<uint32_t>(blen - bh));
      if (btype == kIhdr) has_ihdr = true;
      p += blen;
      size -= blen;
    }
    if (!has_ihdr) fail();  // "no 'ihdr' box"
    state_ |= kHeader;
    info_.has_jp2h = true;
  }

  void img_box(uint32_t t, const uint8_t* p, uint32_t size) {
    Jp2Info& info = info_;
    if (t == kIhdr) {
      if (info.nc != 0) return;  // "Ignoring ihdr box. First ihdr box already read"
      if (size != 14) fail();
      info.h = be32(p);
      info.w = be32(p + 4);
      info.nc = be16(p + 8);
      if (info.nc - 1u >= 16384u) fail();
      info.bpc = p[10];
      if (info.w < 1 || info.h < 1) fail();  // "Wrong values for: w h numcomps (ihdr)"
    } else if (t == kColr) {  // opj_jp2_read_colr
      if (size < 3) fail();
      if (info.has_colr) return;  // the first colr box holds
      const uint8_t meth = p[0];
      if (meth == 1) {
        if (size < 7) fail();
        // a CIELab body of 35 bytes carries its ranges and offsets, one of
        // any other size (7 or not) takes the defaults: neither reader
        // uses them
        info.enumcs = be32(p + 3);
        info.has_colr = true;
      } else if (meth == 2) {
        // an ICC profile, which neither reader applies; opj_calloc of an
        // empty one gives NULL
        if (size == 3) fail();
        info.has_colr = true;
      }
      // any other method: "not a regular value", the box is ignored
    } else if (t == kBpcc) {
      if (size != info.nc) fail();  // "Bad BPCC header box (bad size)"
    } else if (t == kPclr) {  // opj_jp2_read_pclr
      if (info.has_pclr || size < 3) fail();
      Palette& pl = info.pclr;
      pl.ne = static_cast<int>(be16(p));
      if (pl.ne == 0 || pl.ne > 1024) fail();  // "Invalid PCLR box. Reports %d entries"
      pl.npc = p[2];
      if (pl.npc == 0) fail();  // "Reports 0 palette columns"
      if (size < 3u + pl.npc) fail();
      info.has_pclr = true;
      // each entry in the bytes of its column's precision (Bi), 4 at most;
      // neither reader looks at the precision or sign the columns give
      size_t at = 3u + pl.npc;
      pl.entries.resize(static_cast<size_t>(pl.ne) * pl.npc);
      for (size_t k = 0; k < pl.entries.size(); k++) {
        const size_t bytes = std::min(((p[3 + k % pl.npc] & 0x7f) + 8) >> 3, 4);
        if (size < at + bytes) fail();
        uint32_t v = 0;
        for (size_t b = 0; b < bytes; b++) v = v << 8 | p[at + b];
        pl.entries[k] = v;
        at += bytes;
      }
    } else if (t == kCmap) {  // opj_jp2_read_cmap
      if (!info.has_pclr) fail();  // "Need to read a PCLR box before the CMAP box"
      Palette& pl = info.pclr;
      if (pl.has_cmap) fail();  // "Only one CMAP box is allowed"
      if (size < 4u * pl.npc) fail();  // "Insufficient data for CMAP box"
      pl.cmap.resize(pl.npc);
      for (int i = 0; i < pl.npc; i++) {
        const uint8_t* e = p + 4 * i;
        pl.cmap[i] = {be16(e), e[2], e[3]};
      }
      pl.has_cmap = true;
    } else if (t == kCdef) {  // opj_jp2_read_cdef
      if (info.has_cdef) fail();  // at most one cdef box
      if (size < 2) fail();
      const uint32_t cn = be16(p);
      if (cn == 0 || size < 2 + 6 * cn) fail();
      info.has_cdef = true;
      info.cdef.resize(cn);
      for (uint32_t i = 0; i < cn; i++) {
        const uint8_t* e = p + 2 + 6 * i;
        info.cdef[i] = {be16(e), be16(e + 2), be16(e + 4)};
      }
    }
  }

  Jp2Info& info_;
  int state_ = 0;
};

// --------------------------------------------------------- the codestream

constexpr int kMaxBands = 97;

struct StepSize {
  int expn = 0, mant = 0;
};

struct Tccp {  // one component's coding parameters
  int csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
  int qntsty = 0, numgbits = 0, roishift = 0;
  int32_t dc_shift = 0;  // m_dc_level_shift: SIZ's 1 << (prec - 1), or an MCO's
  int prcw[33] = {}, prch[33] = {};
  StepSize steps[kMaxBands];
};

// The code-block styles (SPcod's fourth byte, J2K_CCP_CBLKSTY_*)
enum : int { kLazy = 1, kReset = 2, kTermAll = 4, kVsc = 8, kPterm = 16,
             kSegSym = 32, kHt = 64, kHtMixed = 128 };

// One progression order change (opj_poc_t as opj_j2k_read_poc fills it):
// packets of layers [0, layno1), resolutions [resno0, resno1), components
// [compno0, compno1) in order prg.
struct Poc {
  int resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0, prg = 0;
};

// Packet headers gathered from PPM or PPT markers: the markers by their Z
// index while the header is read (an empty slot: no marker), then the
// headers merged, read from `pos` on.
struct HeaderStore {
  std::vector<std::vector<uint8_t>> markers;
  std::vector<char> present;
  std::vector<uint8_t> data;
  size_t pos = 0;
  void add(const uint8_t* p, uint32_t size) {
    const uint8_t z = p[0];
    if (present.size() <= z) {
      present.resize(z + 1u, 0);
      markers.resize(z + 1u);
    }
    if (present[z]) fail();  // "Zppm %u already read" / "Zppt %u already read"
    present[z] = 1;
    markers[z].assign(p + 1, p + size);
  }
};

// An MCT marker's array (opj_mct_data_t): its Imct index, its element
// type (0 int16, 1 int32, 2 float32, 3 float64) and its bytes.
struct MctArray {
  int index = 0, element = 0;
  std::vector<uint8_t> data;
};

// An MCC marker's collection (opj_simple_mcc_decorrelation_data_t): its
// Imcc index, its component count and its decorrelation and offset arrays
// (positions in Tcp::mct_arrays, -1 for none).
struct MccCollection {
  int index = 0, nb_comps = 0, deco = -1, offset = -1;
};

constexpr size_t kMccSlots = 10;  // OPJ_J2K_MCC_DEFAULT_NB_RECORDS
constexpr size_t kElementSize[4] = {2, 4, 4, 8};  // MCT_ELEMENT_SIZE

struct Tcp {  // one tile's coding parameters and data
  int csty = 0, prg = 0, numlayers = 0, mct = 0;  // prg -1: unknown
  bool cod = false;
  std::vector<Tccp> tccps;
  std::vector<MctArray> mct_arrays;
  // OpenJPEG's MCC slots: the first nb_mcc are collections; a slot past
  // them keeps what a segment that only warned wrote into it
  std::vector<MccCollection> mcc;
  size_t nb_mcc = 0;
  bool poc = false;
  std::vector<Poc> pocs;
  bool ppt = false;
  HeaderStore ppt_store;
  int current_part = -1, nb_parts = 0;
  bool has_data = false;
  std::vector<uint8_t> data;
};

struct CompInfo {
  int dx = 1, dy = 1, prec = 8, sgnd = 0;
};

struct Codestream {
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;  // the image on the reference grid
  int tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
  std::vector<CompInfo> comps;
  Tcp def;  // the main header's
  std::vector<Tcp> tcps;
  // each component's resno_decoded: the highest resolution of a packet
  // read so far, over every tile
  std::vector<int> resno_decoded;
  bool ppm = false;
  HeaderStore ppm_store;
};

// j2k's decoder states
enum { kMhSoc = 1, kMhSiz = 2, kMh = 4, kTphSot = 8, kTph = 16,
       kNeoc = 64, kData = 128, kEoc = 256 };

enum Marker : uint32_t {
  kSOC = 0xff4f, kSIZ = 0xff51, kCOD = 0xff52, kCOC = 0xff53, kTLM = 0xff55,
  kPLM = 0xff57, kPLT = 0xff58, kQCD = 0xff5c, kQCC = 0xff5d, kRGN = 0xff5e,
  kPOC = 0xff5f, kPPM = 0xff60, kPPT = 0xff61, kCRG = 0xff63, kCOM = 0xff64,
  kCAP = 0xff50, kCPF = 0xff59, kCBD = 0xff78, kMCT = 0xff74, kMCC = 0xff75,
  kMCO = 0xff77, kSOT = 0xff90, kSOP = 0xff91, kSOD = 0xff93, kEOC = 0xffd9,
};

// The states a marker may appear in (opj_j2k_memory_marker_handler_tab);
// 0 for one without a handler (the unknown marker's entry, MH | TPH).
int marker_states(uint32_t m, bool& known) {
  known = true;
  switch (m) {
    case kSOT: return kMh | kTphSot;
    case kCOD: case kCOC: case kRGN: case kQCD: case kQCC: case kPOC:
    case kCOM: case kMCT: case kMCC: case kMCO:
      return kMh | kTph;
    case kSIZ: return kMhSiz;
    case kTLM: case kPLM: case kPPM: case kCRG: case kCBD: case kCAP:
    case kCPF:
      return kMh;
    case kPLT: case kPPT: return kTph;
    case kSOP: return 0;  // allowed nowhere a marker segment is read
    default:
      known = false;
      return kMh | kTph;
  }
}

void read_siz(Codestream& cs, const uint8_t* p, uint32_t size,
              const Jp2Info& jp2) {
  if (size < 36 || size % 3 != 0) fail();
  const uint32_t nb_comp = (size - 36) / 3;
  const uint32_t x1 = be32(p + 2), y1 = be32(p + 6), x0 = be32(p + 10),
                 y0 = be32(p + 14), tdx = be32(p + 18), tdy = be32(p + 22),
                 tx0 = be32(p + 26), ty0 = be32(p + 30), csiz = be16(p + 34);
  if (csiz != nb_comp || csiz == 0 || csiz > 16384) fail();
  if (x0 >= x1 || y0 >= y1) fail();
  // "Error with SIZ marker: IHDR w h vs. SIZ w h"
  if (jp2.w > 0 && jp2.h > 0 && (jp2.w != x1 - x0 || jp2.h != y1 - y0)) fail();
  if (tdx == 0 || tdy == 0) fail();
  if (tx0 > x0 || ty0 > y0 || uint64_t{tx0} + tdx <= x0 ||
      uint64_t{ty0} + tdy <= y0)
    fail();
  if (x1 > 0x7fffffffu || y1 > 0x7fffffffu) fail();
  cs.comps.resize(csiz);
  for (uint32_t i = 0; i < csiz; i++) {
    const uint8_t* c = p + 36 + 3 * i;
    CompInfo& ci = cs.comps[i];
    ci.prec = (c[0] & 0x7f) + 1;
    ci.sgnd = c[0] >> 7;
    ci.dx = c[1];
    ci.dy = c[2];
    if (ci.dx < 1 || ci.dy < 1) fail();
    if (ci.prec > 31) fail();
  }
  const uint64_t tw = (uint64_t{x1} - tx0 + tdx - 1) / tdx;
  const uint64_t th = (uint64_t{y1} - ty0 + tdy - 1) / tdy;
  if (tw == 0 || th == 0 || tw > 65535 / th) fail();
  for (const CompInfo& ci : cs.comps)
    if (ci.dx != 1 || ci.dy != 1) unsupported();
  cs.x0 = static_cast<int>(x0);
  cs.y0 = static_cast<int>(y0);
  cs.x1 = static_cast<int>(x1);
  cs.y1 = static_cast<int>(y1);
  cs.tx0 = static_cast<int>(tx0);
  cs.ty0 = static_cast<int>(ty0);
  cs.tdx = static_cast<int>(std::min<uint32_t>(tdx, 0x7fffffffu));
  cs.tdy = static_cast<int>(std::min<uint32_t>(tdy, 0x7fffffffu));
  cs.tw = static_cast<int>(tw);
  cs.th = static_cast<int>(th);
  cs.def.tccps.assign(csiz, Tccp{});
  for (uint32_t i = 0; i < csiz; i++)  // "set up default dc level shift"
    if (!cs.comps[i].sgnd) cs.def.tccps[i].dc_shift = int32_t{1} << (cs.comps[i].prec - 1);
  cs.def.mcc.assign(kMccSlots, MccCollection{});
  cs.resno_decoded.assign(csiz, 0);
}

// opj_j2k_read_SPCod_SPCoc: reads into `t`, returns the bytes read.
uint32_t read_spcod(Tccp& t, int csty, const uint8_t* p, uint32_t size) {
  if (size < 5) fail();
  t.numres = p[0] + 1;
  if (t.numres > 33) fail();
  t.cblkw = p[1] + 2;
  t.cblkh = p[2] + 2;
  if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12) fail();
  t.cblksty = p[3];
  if (t.cblksty & kHtMixed) fail();  // "Unsupported Mixed HT code-block style"
  t.qmfbid = p[4];
  if (t.qmfbid > 1) fail();
  uint32_t used = 5;
  t.csty = csty & 1;
  if (t.csty) {
    if (size - 5 < static_cast<uint32_t>(t.numres)) fail();
    for (int i = 0; i < t.numres; i++) {
      const uint8_t v = p[5 + i];
      if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) fail();
      t.prcw[i] = v & 0xf;
      t.prch[i] = v >> 4;
    }
    used += t.numres;
  } else {
    for (int i = 0; i < t.numres; i++) t.prcw[i] = t.prch[i] = 15;
  }
  return used;
}

// opj_j2k_read_SQcd_SQcc: reads into `t`, returns the bytes read.
uint32_t read_sqcd(Tccp& t, const uint8_t* p, uint32_t size) {
  if (size < 1) fail();
  t.qntsty = p[0] & 0x1f;
  t.numgbits = p[0] >> 5;
  uint32_t nb;
  if (t.qntsty == 1) {
    nb = 1;
  } else {
    nb = t.qntsty == 0 ? size - 1 : (size - 1) / 2;
    if (nb > kMaxBands) {
      // "number of subbands is greater to OPJ_J2K_MAXBANDS": the rest is skipped
    }
  }
  uint32_t used = 1;
  if (t.qntsty == 0) {
    if (size - 1 < nb) fail();
    for (uint32_t b = 0; b < nb; b++) {
      if (b < kMaxBands) {
        t.steps[b].expn = p[1 + b] >> 3;
        t.steps[b].mant = 0;
      }
    }
    used += nb;
  } else {
    if (size - 1 < 2 * nb) fail();
    for (uint32_t b = 0; b < nb; b++) {
      const uint32_t v = be16(p + 1 + 2 * b);
      if (b < kMaxBands) {
        t.steps[b].expn = v >> 11;
        t.steps[b].mant = v & 0x7ff;
      }
    }
    used += 2 * nb;
  }
  if (t.qntsty == 1) {
    for (int b = 1; b < kMaxBands; b++) {
      const int e = t.steps[0].expn - (b - 1) / 3;
      t.steps[b].expn = e > 0 ? e : 0;
      t.steps[b].mant = t.steps[0].mant;
    }
  }
  return used;
}

void read_cod(Tcp& tcp, const uint8_t* p, uint32_t size) {
  if (tcp.cod) fail();  // "No more than one COD marker per tile"
  tcp.cod = true;
  if (size < 5) fail();
  const int csty = p[0];
  if (csty & ~7) fail();  // "Unknown Scod value in COD marker"
  int prg = p[1];
  if (prg > 4) prg = -1;  // "Unknown progression order": fails at decode
  const int layers = static_cast<int>(be16(p + 2));
  if (layers < 1) fail();
  const int mct = p[4];
  if (mct > 1) fail();
  tcp.csty = csty;
  tcp.prg = prg;
  tcp.numlayers = layers;
  tcp.mct = mct;
  Tccp& t0 = tcp.tccps[0];
  const uint32_t used = read_spcod(t0, csty, p + 5, size - 5);
  if (used != size - 5) fail();
  for (size_t c = 1; c < tcp.tccps.size(); c++) {
    Tccp& t = tcp.tccps[c];
    t.csty = t0.csty;
    t.numres = t0.numres;
    t.cblkw = t0.cblkw;
    t.cblkh = t0.cblkh;
    t.cblksty = t0.cblksty;
    t.qmfbid = t0.qmfbid;
    std::memcpy(t.prcw, t0.prcw, sizeof t.prcw);
    std::memcpy(t.prch, t0.prch, sizeof t.prch);
  }
}

int comp_index(const Codestream& cs, const uint8_t*& p, uint32_t& size) {
  const bool two = cs.comps.size() > 256;
  if (size < (two ? 2u : 1u)) fail();
  const uint32_t c = two ? be16(p) : p[0];
  p += two ? 2 : 1;
  size -= two ? 2 : 1;
  if (c >= cs.comps.size()) fail();
  return static_cast<int>(c);
}

void read_coc(const Codestream& cs, Tcp& tcp, const uint8_t* p, uint32_t size) {
  const int c = comp_index(cs, p, size);
  if (size < 1) fail();
  const int csty = p[0];
  if (read_spcod(tcp.tccps[c], csty, p + 1, size - 1) != size - 1) fail();
}

void read_qcd(Tcp& tcp, const uint8_t* p, uint32_t size) {
  if (read_sqcd(tcp.tccps[0], p, size) != size) fail();
  for (size_t c = 1; c < tcp.tccps.size(); c++) {
    Tccp& t = tcp.tccps[c];
    t.qntsty = tcp.tccps[0].qntsty;
    t.numgbits = tcp.tccps[0].numgbits;
    std::memcpy(t.steps, tcp.tccps[0].steps, sizeof t.steps);
  }
}

void read_qcc(const Codestream& cs, Tcp& tcp, const uint8_t* p, uint32_t size) {
  const int c = comp_index(cs, p, size);
  if (read_sqcd(tcp.tccps[c], p, size) != size) fail();
}

// opj_j2k_read_poc: entries appended to those `tcp` holds (a tile's own
// follow those it took from the main header), LYEpoc clamped to the layers
// known when the marker is read and CEpoc to the components.
void read_poc(const Codestream& cs, Tcp& tcp, const uint8_t* p, uint32_t size) {
  const uint32_t nc = static_cast<uint32_t>(cs.comps.size());
  const uint32_t room = nc <= 256 ? 1 : 2, chunk = 5 + 2 * room;
  const uint32_t nb = size / chunk;
  if (nb == 0 || size % chunk != 0) fail();  // "Error reading POC marker"
  const size_t old = tcp.poc ? tcp.pocs.size() : 0;
  if (old + nb >= 32) fail();  // "Too many POCs"
  tcp.poc = true;
  tcp.pocs.resize(old);
  auto rd = [&](uint32_t k) {
    uint32_t v = 0;
    for (uint32_t i = 0; i < k; i++) v = v << 8 | *p++;
    return v;
  };
  for (uint32_t i = 0; i < nb; i++) {
    Poc e;
    e.resno0 = static_cast<int>(rd(1));
    e.compno0 = static_cast<int>(rd(room));
    e.layno1 = static_cast<int>(std::min<uint32_t>(rd(2), static_cast<uint32_t>(tcp.numlayers)));
    e.resno1 = static_cast<int>(rd(1));
    e.compno1 = static_cast<int>(std::min(rd(room), nc));
    e.prg = static_cast<int>(rd(1));
    tcp.pocs.push_back(e);
  }
}

// opj_j2k_read_rgn: Srgn is not checked; SPrgn is the component's shift.
void read_rgn(const Codestream& cs, Tcp& tcp, const uint8_t* p, uint32_t size) {
  const bool two = cs.comps.size() > 256;
  if (size != (two ? 4u : 3u)) fail();  // "Error reading RGN marker"
  const uint32_t c = two ? be16(p) : p[0];
  if (c >= cs.comps.size()) fail();  // "bad component number in RGN"
  tcp.tccps[c].roishift = p[two ? 3 : 2];
}

// opj_j2k_merge_ppm: the Nppm-counted runs of every PPM marker in Zppm
// order (absent indices skipped) joined into one store, the counts dropped;
// a run may continue into the next marker.
void merge_ppm(HeaderStore& st) {
  uint64_t remaining = 0;
  std::vector<uint8_t>& out = st.data;
  for (size_t z = 0; z < st.markers.size(); z++) {
    if (!st.present[z]) continue;
    const std::vector<uint8_t>& m = st.markers[z];
    size_t at = static_cast<size_t>(std::min<uint64_t>(remaining, m.size()));
    out.insert(out.end(), m.begin(), m.begin() + static_cast<std::ptrdiff_t>(at));
    remaining -= at;
    while (at < m.size()) {
      if (m.size() - at < 4) fail();  // "Not enough bytes to read Nppm"
      const uint32_t nppm = be32(m.data() + at);
      at += 4;
      if (out.size() + uint64_t{nppm} + remaining > 0xffffffffu) fail();  // "Too large value for Nppm"
      const size_t k = static_cast<size_t>(std::min<uint64_t>(nppm, m.size() - at));
      out.insert(out.end(), m.begin() + static_cast<std::ptrdiff_t>(at),
                 m.begin() + static_cast<std::ptrdiff_t>(at + k));
      at += k;
      remaining = nppm - k;
    }
  }
  if (remaining != 0) fail();  // "Corrupted PPM markers"
  if (out.empty()) fail();  // opj_malloc(0) gives NULL: "Not enough memory"
  st.markers.clear();
}

// opj_j2k_merge_ppt: the tile's PPT markers in Zppt order joined.
void merge_ppt(HeaderStore& st) {
  for (size_t z = 0; z < st.markers.size(); z++)
    if (st.present[z]) st.data.insert(st.data.end(), st.markers[z].begin(), st.markers[z].end());
  st.markers.clear();
}

// opj_j2k_read_cbd: each component's depth and sign (the DC level shift
// stays SIZ's).
void read_cbd(Codestream& cs, const uint8_t* p, uint32_t size) {
  const size_t nc = cs.comps.size();
  if (size != nc + 2 || be16(p) != nc) fail();  // "Crror reading CBD marker"
  for (size_t c = 0; c < nc; c++) {
    cs.comps[c].prec = (p[2 + c] & 0x7f) + 1;
    cs.comps[c].sgnd = p[2 + c] >> 7;
    if (cs.comps[c].prec > 31) fail();
  }
}

// opj_j2k_read_mct: Zmct, Imct (index, array type, element type), Ymct, the
// array; a segment of Zmct or Ymct not 0 only warns (the latter after the
// array of its index is emptied).
void read_mct(Tcp& tcp, const uint8_t* p, uint32_t size) {
  if (size < 2) fail();
  if (be16(p) != 0) return;  // "Cannot take in charge mct data within multiple MCT records"
  if (size <= 6) fail();
  const uint32_t imct = be16(p + 2);
  const int index = static_cast<int>(imct & 0xff);
  size_t i = 0;
  while (i < tcp.mct_arrays.size() && tcp.mct_arrays[i].index != index) ++i;
  if (i == tcp.mct_arrays.size()) tcp.mct_arrays.emplace_back();
  MctArray& a = tcp.mct_arrays[i];
  a.data.clear();
  a.index = index;
  a.element = static_cast<int>((imct >> 10) & 3);
  if (be16(p + 4) != 0) return;  // "Cannot take in charge multiple MCT markers"
  a.data.assign(p + 6, p + size);
}

// opj_j2k_read_mcc: one array-based collection of components in order
// (Cmcc and Wmcc of 1 or 2 bytes an index), its Tmcc's decorrelation and
// offset indices (0: none) found among the MCT arrays or failing. What it
// cannot take (Zmcc or Ymcc not 0, more than one collection, Xmcc not 1,
// counts that differ, shuffled indices) only warns, leaving what it wrote
// into the slot.
void read_mcc(Tcp& tcp, const uint8_t* p, uint32_t size) {
  if (size < 2) fail();
  if (be16(p) != 0) return;  // "Cannot take in charge multiple data spanning"
  if (size < 7) fail();
  const int index = p[2];
  size_t i = 0;
  while (i < tcp.nb_mcc && tcp.mcc[i].index != index) ++i;
  const bool fresh = i == tcp.nb_mcc;
  if (fresh && tcp.nb_mcc == tcp.mcc.size()) tcp.mcc.resize(tcp.mcc.size() + kMccSlots);
  MccCollection& r = tcp.mcc[i];
  r.index = index;
  if (be16(p + 3) != 0) return;  // Ymcc: "multiple data spanning"
  const uint32_t collections = be16(p + 5);
  if (collections > 1) return;  // "Cannot take in charge multiple collections"
  p += 7;
  size -= 7;
  auto in_order = [&](uint32_t width) {  // Cmcc / Wmcc: 0, 1, 2, ...
    for (int j = 0; j < r.nb_comps; j++, p += width)
      if ((width == 2 ? be16(p) : p[0]) != static_cast<uint32_t>(j)) return false;
    return true;
  };
  auto array = [&](uint32_t at) {
    if (at == 0) return -1;
    for (size_t k = 0; k < tcp.mct_arrays.size(); k++)
      if (tcp.mct_arrays[k].index == static_cast<int>(at)) return static_cast<int>(k);
    fail();  // "Error reading MCC marker"
  };
  for (uint32_t k = 0; k < collections; k++) {
    if (size < 3) fail();
    if (p[0] != 1) return;  // "collections other than array decorrelation"
    uint32_t n = be16(p + 1);
    p += 3;
    size -= 3;
    uint32_t width = 1 + (n >> 15);
    r.nb_comps = static_cast<int>(n & 0x7fff);
    if (size < width * r.nb_comps + 2) fail();
    size -= width * r.nb_comps + 2;
    if (!in_order(width)) return;  // "collections with indix shuffle"
    n = be16(p);
    p += 2;
    width = 1 + (n >> 15);
    if (static_cast<int>(n & 0x7fff) != r.nb_comps) return;  // "without same number of indixes"
    if (size < width * r.nb_comps + 3) fail();
    size -= width * r.nb_comps + 3;
    if (!in_order(width)) return;
    const uint32_t t = uint32_t{p[0]} << 16 | uint32_t{p[1]} << 8 | p[2];
    r.deco = array(t & 0xff);
    r.offset = array((t >> 8) & 0xff);
  }
  if (size != 0) fail();
  if (fresh) tcp.nb_mcc++;
}

// j2k_mct_read_functions_to_int32: an offset array's element. int16 is read
// unsigned; a float is truncated as x86-64's cvttss2si / cvttsd2si does
// (0x80000000 where it leaves int32's range).
int32_t mct_element(const MctArray& a, size_t k) {
  const uint8_t* q = a.data.data() + k * kElementSize[a.element];
  if (a.element == 0) return static_cast<int32_t>(be16(q));
  if (a.element == 1) return static_cast<int32_t>(be32(q));
  double v;
  if (a.element == 2) {
    float f;
    const uint32_t bits = be32(q);
    std::memcpy(&f, &bits, 4);
    v = f;
  } else {
    const uint64_t bits = uint64_t{be32(q)} << 32 | be32(q + 4);
    std::memcpy(&v, &bits, 8);
  }
  if (!(v > -2147483649.0 && v < 2147483648.0)) return INT32_MIN;
  return static_cast<int32_t>(v);
}

// opj_j2k_read_mco and opj_j2k_add_mct: one stage (more only warn), every
// DC level shift zeroed, then the stage's collection applied: its offset
// array becomes the shifts, its decorrelation matrix is only checked (only
// opj_tcd_mct_decode's MCT 2 branch reads it). add_mct's search never steps
// past the first collection, and a collection of another component count
// is discarded.
void read_mco(const Codestream& cs, Tcp& tcp, const uint8_t* p, uint32_t size) {
  if (size < 1) fail();
  const uint32_t stages = p[0];
  if (stages > 1) return;  // "Cannot take in charge multiple transformation stages."
  if (size != stages + 1) fail();
  for (Tccp& t : tcp.tccps) t.dc_shift = 0;
  if (stages == 0 || tcp.nb_mcc == 0 || tcp.mcc[0].index != p[1]) return;
  const MccCollection& r = tcp.mcc[0];
  const size_t nc = cs.comps.size();
  if (static_cast<size_t>(r.nb_comps) != nc) return;
  if (r.deco >= 0) {
    const MctArray& a = tcp.mct_arrays[r.deco];
    if (a.data.size() != kElementSize[a.element] * nc * nc) fail();
  }
  if (r.offset >= 0) {
    const MctArray& a = tcp.mct_arrays[r.offset];
    if (a.data.size() != kElementSize[a.element] * nc) fail();
    for (size_t c = 0; c < nc; c++) tcp.tccps[c].dc_shift = mct_element(a, c);
  }
}

// A marker segment's handler, main header or tile-part header (`tcp`).
void read_segment(Codestream& cs, Tcp& tcp, uint32_t m, const uint8_t* p,
                  uint32_t size) {
  switch (m) {
    case kPOC: read_poc(cs, tcp, p, size); break;
    case kRGN: read_rgn(cs, tcp, p, size); break;
    case kPPM:
      if (size < 2) fail();  // "Error reading PPM marker"
      cs.ppm = true;
      cs.ppm_store.add(p, size);
      break;
    case kPPT:
      if (size < 2) fail();  // "Error reading PPT marker"
      if (cs.ppm) fail();  // "packet header have been previously found in the main header"
      tcp.ppt = true;
      tcp.ppt_store.add(p, size);
      break;
    case kCOD: read_cod(tcp, p, size); break;
    case kCOC: read_coc(cs, tcp, p, size); break;
    case kQCD: read_qcd(tcp, p, size); break;
    case kQCC: read_qcc(cs, tcp, p, size); break;
    case kCOM:
      break;
    case kCRG:
      if (size != cs.comps.size() * 4) fail();
      break;
    case kTLM:
      if (size < 2) fail();
      {
        const int st = (p[1] >> 4) & 3, sp = (p[1] >> 6) & 1;
        if (st == 3) fail();
        const uint32_t quanta = st + (sp ? 4 : 2);
        if ((size - 2) % quanta != 0) fail();
      }
      break;
    case kPLM:
      if (size < 1) fail();
      break;
    case kPLT:
      if (size < 1) fail();
      {
        // each length ends on a byte without its high bit
        bool open = false;
        for (uint32_t i = 1; i < size; i++) open = (p[i] & 0x80) != 0;
        if (open) fail();
      }
      break;
    case kCAP:
    case kCPF:  // opj_j2k_read_cap and opj_j2k_read_cpf read nothing
      break;
    case kCBD: read_cbd(cs, p, size); break;
    case kMCT: read_mct(tcp, p, size); break;
    case kMCC: read_mcc(tcp, p, size); break;
    case kMCO: read_mco(cs, tcp, p, size); break;
  }
}

// opj_j2k_read_header_procedure: SOC, then marker segments up to the first
// SOT (whose marker the stream has read); `cs.tcps` become the main
// header's.
void read_main_header(Stream& s, Codestream& cs, int& state,
                      const Jp2Info& jp2) {
  uint32_t m;
  if (!s.read16(m) || m != kSOC) fail();
  state = kMhSiz;
  if (!s.read16(m)) fail();
  bool has_siz = false, has_cod = false, has_qcd = false;
  std::vector<uint8_t> seg;
  while (m != kSOT) {
    if (m < 0xff00) fail();
    bool known;
    int states = marker_states(m, known);
    if (!known) {
      // opj_j2k_read_unk: two bytes at a time up to a known marker allowed
      // where the decoder stands
      for (;;) {
        uint32_t u;
        if (!s.read16(u)) fail();
        if (u < 0xff00) continue;
        bool k2;
        const int st2 = marker_states(u, k2);
        if (!(state & st2)) fail();
        if (k2) {
          m = u;
          states = st2;
          break;
        }
      }
      if (m == kSOT) break;
    }
    if (m == kSIZ) has_siz = true;
    if (m == kCOD) has_cod = true;
    if (m == kQCD) has_qcd = true;
    if (!(state & states)) fail();
    uint32_t len;
    if (!s.read16(len)) fail();
    if (len < 2) fail();
    len -= 2;
    seg.resize(len + 1);
    if (!s.read(seg.data(), len)) fail();
    if (m == kSIZ) {
      read_siz(cs, seg.data(), len, jp2);
      state = kMh;
    } else {
      if (cs.comps.empty()) fail();
      read_segment(cs, cs.def, m, seg.data(), len);
    }
    if (!s.read16(m)) fail();
  }
  if (!has_siz || !has_cod || !has_qcd) fail();
  if (cs.ppm) merge_ppm(cs.ppm_store);  // "Failed to merge PPM data"
  Tcp tile = cs.def;
  tile.cod = false;
  cs.tcps.assign(static_cast<size_t>(cs.tw) * cs.th, tile);
  state = kTphSot;
}


// ------------------------------------------------------------- tier 2

// opj_bio: a packet header's bits, a 0xFF byte followed by 7 bits; past the
// end the bits read 0 and the position stays.
struct Bio {
  const uint8_t *start, *end, *bp;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* p, size_t n) : start(p), end(p + n), bp(p) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; i--) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  size_t numbytes() const { return static_cast<size_t>(bp - start); }
};

// opj_tgt: a tag tree over w x h leaves (parents by halving, row-major
// level after level).
struct TagTree {
  std::vector<int> parent, value, low;
  void init(int w, int h) {
    parent.clear();
    std::vector<int> lw{w}, lh{h};
    int n;
    size_t total = 0;
    do {
      n = lw.back() * lh.back();
      total += n;
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    } while (n > 1);
    parent.assign(total, -1);
    size_t base = 0;
    for (size_t l = 0; l + 2 < lw.size(); l++) {
      const size_t next = base + static_cast<size_t>(lw[l]) * lh[l];
      for (int j = 0; j < lh[l]; j++)
        for (int i = 0; i < lw[l]; i++)
          parent[base + static_cast<size_t>(j) * lw[l] + i] =
              static_cast<int>(next + static_cast<size_t>(j / 2) * lw[l + 1] + i / 2);
      base = next;
    }
    value.assign(total, 999);
    low.assign(total, 0);
  }
  bool decode(Bio& bio, int leaf, int threshold) {
    int stk[32], sp = 0;
    int node = leaf;
    while (parent[node] >= 0) {
      stk[sp++] = node;
      node = parent[node];
    }
    int lo = 0;
    for (;;) {
      if (lo > low[node]) {
        low[node] = lo;
      } else {
        lo = low[node];
      }
      while (lo < threshold && lo < value[node]) {
        if (bio.bit()) {
          value[node] = lo;
        } else {
          ++lo;
        }
      }
      low[node] = lo;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return value[node] < threshold;
  }
};

struct Seg {
  int numpasses = 0, maxpasses = 109, numnewpasses = 0;
  uint32_t newlen = 0;
  std::vector<uint8_t> data;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0;
  // the HT decoder's: the band's bit-planes when the block is first
  // included (Mb), its data's pieces (one a segment a packet, empty ones
  // too) and where the first lies in the tile's data
  uint32_t mb = 0;
  int numchunks = 0;
  size_t chunk0 = 0;
  std::vector<Seg> segs;
};

// opj_t2_init_seg: a new segment's pass count by the code-block style: one
// pass under TERMALL; under BYPASS 10 first, then 2 and 1 in turn; else
// 109. The HT style changes none of it (opj_t2_read_packet_header's HT
// branch sets each segment's new passes itself).
void init_seg(Cblk& cb, size_t index, int cblksty, bool first) {
  if (cb.segs.size() <= index) cb.segs.resize(index + 1);
  Seg& sg = cb.segs[index];
  sg = Seg{};
  if (cblksty & kTermAll) {
    sg.maxpasses = 1;
  } else if (cblksty & kLazy) {
    const int prev = first ? 0 : cb.segs[index - 1].maxpasses;
    sg.maxpasses = first ? 10 : (prev == 1 || prev == 10) ? 2 : 1;
  } else {
    sg.maxpasses = 109;
  }
}

struct Prc {
  int x0, y0, x1, y1, cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno = 0, x0 = 0, y0 = 0, x1 = 0, y1 = 0, numbps = 0;
  float stepsize = 0;
  std::vector<Prc> prcs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  int x0, y0, x1, y1, pw = 0, ph = 0, pdx = 0, pdy = 0, numbands = 0;
  Band bands[3];
};

struct TileComp {
  int x0, y0, x1, y1, numres = 0;
  int rd = 0;  // the resolution decoded: its samples at the top left
  std::vector<Res> res;
  std::vector<int32_t> idata;  // the 5/3's coefficients, then the samples
  std::vector<float> fdata;    // the 9/7's coefficients
  int w() const { return x1 - x0; }
  int h() const { return y1 - y0; }
  const Res& out() const { return res[rd]; }
  int out_w() const { return out().x1 - out().x0; }
  int out_h() const { return out().y1 - out().y0; }
};

// opj_tcd_init_tile for a decode: resolutions, bands, precincts and
// code-blocks of each component of the tile at (tx0, ty0)-(tx1, ty1).
void init_tile(const Codestream& cs, const Tcp& tcp, int tx0, int ty0,
               int tx1, int ty1, std::vector<TileComp>& tile) {
  tile.assign(cs.comps.size(), TileComp{});
  for (size_t c = 0; c < cs.comps.size(); c++) {
    const Tccp& tccp = tcp.tccps[c];
    TileComp& tc = tile[c];
    tc.x0 = tx0;
    tc.y0 = ty0;
    tc.x1 = tx1;
    tc.y1 = ty1;
    tc.numres = tccp.numres;
    tc.res.resize(tc.numres);
    const size_t area = static_cast<size_t>(tc.w()) * tc.h();
    if (tccp.qmfbid == 1)
      tc.idata.assign(area, 0);
    else
      tc.fdata.assign(area, 0.0f);
    const int prec = cs.comps[c].prec;
    int level = tc.numres;
    int step = 0;
    for (int r = 0; r < tc.numres; r++) {
      --level;
      Res& res = tc.res[r];
      res.x0 = ceildivpow2(tc.x0, level);
      res.y0 = ceildivpow2(tc.y0, level);
      res.x1 = ceildivpow2(tc.x1, level);
      res.y1 = ceildivpow2(tc.y1, level);
      res.pdx = tccp.prcw[r];
      res.pdy = tccp.prch[r];
      const int tlx = floordivpow2(res.x0, res.pdx) << res.pdx;
      const int tly = floordivpow2(res.y0, res.pdy) << res.pdy;
      const int64_t brx = int64_t{ceildivpow2(res.x1, res.pdx)} << res.pdx;
      const int64_t bry = int64_t{ceildivpow2(res.y1, res.pdy)} << res.pdy;
      if (brx > 0x7fffffff || bry > 0x7fffffff) fail();
      res.pw = res.x0 == res.x1 ? 0 : static_cast<int>((brx - tlx) >> res.pdx);
      res.ph = res.y0 == res.y1 ? 0 : static_cast<int>((bry - tly) >> res.pdy);
      if (int64_t{res.pw} * res.ph > (int64_t{1} << 26)) fail();
      int cbgx, cbgy, cbgw, cbgh;
      if (r == 0) {
        cbgx = tlx;
        cbgy = tly;
        cbgw = res.pdx;
        cbgh = res.pdy;
        res.numbands = 1;
      } else {
        cbgx = ceildivpow2(tlx, 1);
        cbgy = ceildivpow2(tly, 1);
        cbgw = res.pdx - 1;
        cbgh = res.pdy - 1;
        res.numbands = 3;
      }
      const int cbw = std::min(tccp.cblkw, cbgw), cbh = std::min(tccp.cblkh, cbgh);
      for (int b = 0; b < res.numbands; b++, step++) {
        Band& band = res.bands[b];
        if (r == 0) {
          band.bandno = 0;
          band.x0 = ceildivpow2(tc.x0, level);
          band.y0 = ceildivpow2(tc.y0, level);
          band.x1 = ceildivpow2(tc.x1, level);
          band.y1 = ceildivpow2(tc.y1, level);
        } else {
          band.bandno = b + 1;
          const int xob = band.bandno & 1, yob = band.bandno >> 1;
          band.x0 = ceildivpow2(tc.x0 - (int64_t{xob} << level), level + 1);
          band.y0 = ceildivpow2(tc.y0 - (int64_t{yob} << level), level + 1);
          band.x1 = ceildivpow2(tc.x1 - (int64_t{xob} << level), level + 1);
          band.y1 = ceildivpow2(tc.y1 - (int64_t{yob} << level), level + 1);
        }
        const StepSize& ss = tccp.steps[std::min(step, kMaxBands - 1)];
        // BUG_WEIRD_TWO_INVK: the 9/7 decoder's gain is 0 for every band
        const int gain = tccp.qmfbid == 0 ? 0 : band.bandno == 0 ? 0
                         : band.bandno == 3 ? 2 : 1;
        const int rb = prec + gain;
        band.stepsize = static_cast<float>(
            (1.0 + ss.mant / 2048.0) * std::pow(2.0, rb - ss.expn));
        band.numbps = ss.expn + tccp.numgbits - 1;
        if (band.empty()) continue;
        band.prcs.resize(static_cast<size_t>(res.pw) * res.ph);
        for (int p = 0; p < res.pw * res.ph; p++) {
          Prc& prc = band.prcs[p];
          const int sx = cbgx + (p % res.pw) * (1 << cbgw);
          const int sy = cbgy + (p / res.pw) * (1 << cbgh);
          prc.x0 = std::max(sx, band.x0);
          prc.y0 = std::max(sy, band.y0);
          prc.x1 = std::min(sx + (1 << cbgw), band.x1);
          prc.y1 = std::min(sy + (1 << cbgh), band.y1);
          const int tcx = floordivpow2(prc.x0, cbw) << cbw;
          const int tcy = floordivpow2(prc.y0, cbh) << cbh;
          const int bcx = ceildivpow2(prc.x1, cbw) << cbw;
          const int bcy = ceildivpow2(prc.y1, cbh) << cbh;
          prc.cw = prc.x1 > prc.x0 ? (bcx - tcx) >> cbw : 0;
          prc.ch = prc.y1 > prc.y0 ? (bcy - tcy) >> cbh : 0;
          if (prc.cw == 0 || prc.ch == 0) {
            prc.cw = prc.ch = 0;
            continue;
          }
          prc.incl.init(prc.cw, prc.ch);
          prc.imsb.init(prc.cw, prc.ch);
          prc.cblks.resize(static_cast<size_t>(prc.cw) * prc.ch);
          for (int k = 0; k < prc.cw * prc.ch; k++) {
            Cblk& cb = prc.cblks[k];
            const int cx = tcx + (k % prc.cw) * (1 << cbw);
            const int cy = tcy + (k / prc.cw) * (1 << cbh);
            cb.x0 = std::max(cx, prc.x0);
            cb.y0 = std::max(cy, prc.y0);
            cb.x1 = std::min(cx + (1 << cbw), prc.x1);
            cb.y1 = std::min(cy + (1 << cbh), prc.y1);
          }
        }
      }
    }
  }
}

// opj_t2_decode_packet: one packet's header then its data, from `d` with
// `n` bytes left in the tile (whose data starts at `base`); returns the
// bytes it took. The header comes from `store` (PPM or PPT) where there is
// one, the SOP marker and the data from `d`.
size_t read_packet(const Tcp& tcp, std::vector<TileComp>& tile, int compno,
                   int resno, int precno, int layno, const uint8_t* base,
                   const uint8_t* d, size_t n, HeaderStore* store) {
  Res& res = tile[compno].res[resno];
  const int cblksty = tcp.tccps[compno].cblksty;
  const uint8_t* cur = d;
  // SOP
  if (tcp.csty & 2) {
    if (n >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
  }
  const uint8_t* hstart = store ? store->data.data() + store->pos : cur;
  const size_t remaining = store ? store->data.size() - store->pos
                                 : n - static_cast<size_t>(cur - d);
  Bio bio(hstart, remaining);
  const bool present = bio.bit();
  // the header's end: its EPH, required after every packet header, an
  // empty packet's too; the store moves past it, or the data begins there
  auto header_end = [&]() {
    bio.inalign();
    const uint8_t* h = hstart + bio.numbytes();
    if (tcp.csty & 4) {
      const size_t used = static_cast<size_t>(h - hstart);
      if (remaining - used < 2) fail();  // "Not enough space for required EPH"
      if (h[0] != 0xff || h[1] != 0x92) fail();  // "Expected EPH marker"
      h += 2;
    }
    if (!store) return h;
    store->pos += static_cast<size_t>(h - hstart);
    return cur;
  };
  if (!present) return static_cast<size_t>(header_end() - d);
  for (int b = 0; b < res.numbands; b++) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    if (precno >= static_cast<int>(band.prcs.size())) fail();
    Prc& prc = band.prcs[precno];
    for (int k = 0; k < prc.cw * prc.ch; k++) {
      Cblk& cb = prc.cblks[k];
      bool included;
      if (cb.numsegs == 0)
        included = prc.incl.decode(bio, k, layno + 1);
      else
        included = bio.bit();
      if (!included) {
        cb.numnewpasses = 0;
        continue;
      }
      if (cb.numsegs == 0) {
        int i = 0;
        while (!prc.imsb.decode(bio, k, i)) {
          if (++i > 2048) fail();
        }
        cb.mb = static_cast<uint32_t>(band.numbps);
        cb.numbps = band.numbps + 1 - i;
        cb.numlenbits = 3;
      }
      // opj_t2_getnumpasses
      int np;
      if (!bio.bit()) {
        np = 1;
      } else if (!bio.bit()) {
        np = 2;
      } else {
        const int t2 = static_cast<int>(bio.read(2));
        if (t2 != 3) {
          np = 3 + t2;
        } else {
          const int t5 = static_cast<int>(bio.read(5));
          np = t5 != 31 ? 6 + t5 : 37 + static_cast<int>(bio.read(7));
        }
      }
      cb.numnewpasses = np;
      // opj_t2_getcommacode
      int inc = 0;
      while (bio.bit()) inc++;
      cb.numlenbits += inc;
      size_t segno;
      if (cb.numsegs == 0) {
        segno = 0;
        init_seg(cb, 0, cblksty, true);
      } else {
        segno = cb.numsegs - 1;
        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses)
          init_seg(cb, ++segno, cblksty, false);
      }
      int left = np;
      do {
        Seg& sg = cb.segs[segno];
        // an HT block: the first segment takes one pass (the cleanup), any
        // later one all that are left, whatever its maxpasses
        if (cblksty & kHt)
          sg.numnewpasses = segno == 0 ? 1 : left;
        else
          sg.numnewpasses = std::min(sg.maxpasses - sg.numpasses, left);
        const int bits = cb.numlenbits + floorlog2(static_cast<uint32_t>(sg.numnewpasses));
        if (bits > 32) fail();
        sg.newlen = bio.read(bits);
        left -= sg.numnewpasses;
        if (left > 0) init_seg(cb, ++segno, cblksty, false);
      } while (left > 0);
    }
  }
  const uint8_t* h = header_end();
  // opj_t2_read_packet_data
  const uint8_t* end = d + n;
  for (int b = 0; b < res.numbands; b++) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Prc& prc = band.prcs[precno];
    for (Cblk& cb : prc.cblks) {
      if (!cb.numnewpasses) continue;
      size_t segno;
      if (!cb.numsegs) {
        segno = 0;
        ++cb.numsegs;
      } else {
        segno = cb.numsegs - 1;
        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
          ++segno;
          ++cb.numsegs;
        }
      }
      do {
        Seg& sg = cb.segs[segno];
        if (sg.newlen > static_cast<size_t>(end - h)) fail();  // "segment too long"
        if (cb.numchunks++ == 0) cb.chunk0 = static_cast<size_t>(h - base);
        sg.data.insert(sg.data.end(), h, h + sg.newlen);
        h += sg.newlen;
        sg.numpasses += sg.numnewpasses;
        cb.numnewpasses -= sg.numnewpasses;
        if (cb.numnewpasses > 0) {
          ++segno;
          ++cb.numsegs;
        }
      } while (cb.numnewpasses > 0);
    }
  }
  return static_cast<size_t>(h - d);
}

// opj_pi_create_decode / opj_pi_next_*: the packets of a tile, each once
// (one include table across the entries): the COD's progression over every
// packet, or each POC entry's in turn (opj_pi_update_decode_poc: layers from
// 0, no bound on REpoc; CEpoc was clamped to the components, so an entry
// whose CSpoc lies past them reaches none). An entry whose order is not one
// of the five brings no packet; a COD order that is not one of them fails
// the tile.
void decode_packets(const Tcp& tcp, int tx0, int ty0, int tx1, int ty1,
                    std::vector<TileComp>& tile,
                    const std::vector<uint8_t>& data, HeaderStore* store,
                    std::vector<int>& resno_decoded) {
  const int nc = static_cast<int>(tile.size());
  const int layers = tcp.numlayers;
  int maxres = 0, maxprec = 0;
  for (const TileComp& tc : tile) {
    maxres = std::max(maxres, tc.numres);
    for (const Res& r : tc.res) maxprec = std::max(maxprec, r.pw * r.ph);
  }
  std::vector<uint8_t> include(static_cast<size_t>(layers) * maxres * nc *
                                   std::max(maxprec, 1), 0);
  size_t pos = 0;
  auto packet = [&](int c, int r, int p, int l) {
    const size_t idx = ((static_cast<size_t>(l) * maxres + r) * nc + c) *
                           std::max(maxprec, 1) + p;
    if (include[idx]) return;
    include[idx] = 1;
    pos += read_packet(tcp, tile, c, r, p, l, data.data(), data.data() + pos,
                       data.size() - pos, store);
    resno_decoded[c] = std::max(resno_decoded[c], r);
  };
  // a position progression's step over components [c0, c1)
  auto step = [&](int c0, int c1, uint32_t& dx, uint32_t& dy) {
    dx = dy = 0;
    for (int c = c0; c < c1; c++) {
      const TileComp& tc = tile[c];
      for (int r = 0; r < tc.numres; r++) {
        const int ex = tc.res[r].pdx + tc.numres - 1 - r;
        const int ey = tc.res[r].pdy + tc.numres - 1 - r;
        if (ex < 32) dx = dx ? std::min(dx, 1u << ex) : 1u << ex;
        if (ey < 32) dy = dy ? std::min(dy, 1u << ey) : 1u << ey;
      }
    }
    return dx != 0 && dy != 0;
  };
  // the packets of layers [0, layno1) of the precinct at (x, y)
  auto at = [&](int c, int r, uint32_t x, uint32_t y, int layno1) {
    const TileComp& tc = tile[c];
    if (r >= tc.numres) return;
    const Res& res = tc.res[r];
    const int level = tc.numres - 1 - r;
    auto cdiv = [](uint64_t a, uint64_t b) { return static_cast<uint32_t>((a + b - 1) / b); };
    const uint32_t trx0 = cdiv(static_cast<uint32_t>(tx0), uint64_t{1} << level);
    const uint32_t try0 = cdiv(static_cast<uint32_t>(ty0), uint64_t{1} << level);
    const uint32_t trx1 = cdiv(static_cast<uint32_t>(tx1), uint64_t{1} << level);
    const uint32_t try1 = cdiv(static_cast<uint32_t>(ty1), uint64_t{1} << level);
    const int rpx = res.pdx + level, rpy = res.pdy + level;
    if (rpx >= 31 || rpy >= 31) return;
    if (!((y % (1u << rpy)) == 0 ||
          (y == static_cast<uint32_t>(ty0) && ((uint64_t{try0} << level) % (1u << rpy)))))
      return;
    if (!((x % (1u << rpx)) == 0 ||
          (x == static_cast<uint32_t>(tx0) && ((uint64_t{trx0} << level) % (1u << rpx)))))
      return;
    if (res.pw == 0 || res.ph == 0) return;
    if (trx0 == trx1 || try0 == try1) return;
    const uint32_t prci = (cdiv(x, uint64_t{1} << level) >> res.pdx) - (trx0 >> res.pdx);
    const uint32_t prcj = (cdiv(y, uint64_t{1} << level) >> res.pdy) - (try0 >> res.pdy);
    const uint32_t p = prci + prcj * static_cast<uint32_t>(res.pw);
    if (p >= static_cast<uint32_t>(std::max(maxprec, 1))) fail();
    for (int l = 0; l < layno1; l++) packet(c, r, static_cast<int>(p), l);
  };
  const uint32_t ux0 = static_cast<uint32_t>(tx0), uy0 = static_cast<uint32_t>(ty0);
  const uint32_t ux1 = static_cast<uint32_t>(tx1), uy1 = static_cast<uint32_t>(ty1);
  std::vector<Poc> entries;
  if (tcp.poc) {
    entries = tcp.pocs;
    for (Poc& e : entries) e.layno1 = std::min(e.layno1, layers);
  } else {
    entries.push_back(Poc{0, 0, layers, maxres, nc, tcp.prg});
  }
  for (const Poc& e : entries) {
    if (e.prg < 0) fail();  // OPJ_PROG_UNKNOWN
    uint32_t dx, dy;
    switch (e.prg) {
      case 0:  // LRCP
        for (int l = 0; l < e.layno1; l++)
          for (int r = e.resno0; r < e.resno1; r++)
            for (int c = e.compno0; c < e.compno1; c++) {
              if (r >= tile[c].numres) continue;
              const Res& res = tile[c].res[r];
              for (int p = 0; p < res.pw * res.ph; p++) packet(c, r, p, l);
            }
        break;
      case 1:  // RLCP
        for (int r = e.resno0; r < e.resno1; r++)
          for (int l = 0; l < e.layno1; l++)
            for (int c = e.compno0; c < e.compno1; c++) {
              if (r >= tile[c].numres) continue;
              const Res& res = tile[c].res[r];
              for (int p = 0; p < res.pw * res.ph; p++) packet(c, r, p, l);
            }
        break;
      case 2:  // RPCL
        if (!step(0, nc, dx, dy)) break;
        for (int r = e.resno0; r < e.resno1; r++)
          for (uint32_t y = uy0; y < uy1; y += dy - (y % dy))
            for (uint32_t x = ux0; x < ux1; x += dx - (x % dx))
              for (int c = e.compno0; c < e.compno1; c++) at(c, r, x, y, e.layno1);
        break;
      case 3:  // PCRL
        if (!step(0, nc, dx, dy)) break;
        for (uint32_t y = uy0; y < uy1; y += dy - (y % dy))
          for (uint32_t x = ux0; x < ux1; x += dx - (x % dx))
            for (int c = e.compno0; c < e.compno1; c++)
              for (int r = e.resno0; r < std::min(e.resno1, tile[c].numres); r++)
                at(c, r, x, y, e.layno1);
        break;
      case 4:  // CPRL
        for (int c = e.compno0; c < e.compno1; c++) {
          if (!step(c, c + 1, dx, dy)) break;
          for (uint32_t y = uy0; y < uy1; y += dy - (y % dy))
            for (uint32_t x = ux0; x < ux1; x += dx - (x % dx))
              for (int r = e.resno0; r < std::min(e.resno1, tile[c].numres); r++)
                at(c, r, x, y, e.layno1);
        }
        break;
      default:  // opj_pi_next: no packet
        break;
    }
  }
}

// ------------------------------------------------------------- tier 1

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
constexpr MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

// The MQ decoder (opj_mqc, Annex C), over a segment that OpenJPEG ends with
// an artificial FF FF marker.
struct Mq {
  const uint8_t* bp;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[19], mps[19];
  std::vector<uint8_t> buf;
  void reset_contexts() {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[18] = 46;  // uniform
    state[17] = 3;   // run length
    state[0] = 4;    // zero coding, no significant neighbour
  }
  void bytein() {
    if (*bp == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += uint32_t{*bp} << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += uint32_t{*bp} << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* d, size_t n) {
    buf.assign(d, d + n);
    buf.push_back(0xff);
    buf.push_back(0xff);
    bp = buf.data();
    c = n == 0 ? 0xffu << 16 : uint32_t{*bp} << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  // opj_mqc_raw_init_dec / opj_mqc_raw_decode: the bypass mode's raw bits,
  // 7 of them in a byte that follows 0xFF; a 0xFF followed by a byte above
  // 0x8F (the artificial marker among them) reads as ones from there on.
  void raw_init(const uint8_t* d, size_t n) {
    buf.assign(d, d + n);
    buf.push_back(0xff);
    buf.push_back(0xff);
    bp = buf.data();
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    ct--;
    return static_cast<int>((c >> ct) & 1);
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = kMq[state[cx]];
    const uint32_t qe = s.qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = static_cast<uint8_t>(1 - mps[cx]);
        state[cx] = s.nlps;
      }
      a = qe;
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = static_cast<uint8_t>(1 - mps[cx]);
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// The contexts of Annex D by a coefficient's neighbourhood word: bits 0-7
// its W, E, N, S, NW, NE, SW and SE neighbours' significance, bits 8-11 the
// W, E, N and S neighbours' signs (1: negative).
enum : uint16_t {
  kW = 1, kE = 2, kN = 4, kS = 8, kNW = 16, kNE = 32, kSW = 64, kSE = 128,
  kNeighbours = 0xff, kWNeg = 256, kENeg = 512, kNNeg = 1024, kSNeg = 2048,
  kSig = 1 << 12, kVisit = 1 << 13, kRefined = 1 << 14,
};

struct T1Tables {
  uint8_t zc[4][256];      // by orientation and neighbour significance
  uint8_t sc[256], sx[256];  // by (W, E, N, S significance, their signs)
  T1Tables() {
    for (int o = 0; o < 4; o++)
      for (int m = 0; m < 256; m++) {
        int h = !!(m & kW) + !!(m & kE), v = !!(m & kN) + !!(m & kS);
        const int d = !!(m & kNW) + !!(m & kNE) + !!(m & kSW) + !!(m & kSE);
        int c;
        if (o == 3) {
          const int hv = h + v;
          c = d >= 3 ? 8 : d == 2 ? (hv >= 1 ? 7 : 6)
              : d == 1 ? (hv >= 2 ? 5 : hv == 1 ? 4 : 3)
              : hv >= 2 ? 2 : hv == 1 ? 1 : 0;
        } else {
          if (o == 1) std::swap(h, v);  // HL: vertical neighbours lead
          c = h == 2 ? 8 : h == 1 ? (v >= 1 ? 7 : d >= 1 ? 6 : 5)
              : v == 2 ? 4 : v == 1 ? 3 : d >= 2 ? 2 : d == 1 ? 1 : 0;
        }
        zc[o][m] = static_cast<uint8_t>(c);
      }
    // Table D.3: rows by H (-1, 0, 1), columns by V (-1, 0, 1)
    static const int ctx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
    for (int m = 0; m < 256; m++) {
      auto part = [&](int sig, int neg) { return (m & sig) ? ((m & neg) ? -1 : 1) : 0; };
      const int h = std::clamp(part(1, 16) + part(2, 32), -1, 1);
      const int v = std::clamp(part(4, 64) + part(8, 128), -1, 1);
      sc[m] = static_cast<uint8_t>(ctx[h + 1][v + 1]);
      sx[m] = (h == -1 || (h == 0 && v == -1)) ? 1 : 0;
    }
  }
};

// One code-block's coefficients through the three passes (Annex D), in
// OpenJPEG's doubled scale: a coefficient that becomes significant at
// bit-plane p holds 3 << p (half a step above its bit), each refinement
// moves it by half its current step. The code-block style (opj_t1_decode_
// cblk): under BYPASS a segment that starts with a significance pass at
// least 4 bit-planes below the block's first is raw; RESET resets the
// contexts after each MQ pass; VSC hides a stripe's next row from its last;
// SEGSYM reads 4 uniform symbols after each cleanup pass and ignores them;
// PTERM changes nothing (OpenJPEG's check of it only warns).
class T1 {
 public:
  T1(int w, int h, int orient, int cblksty) : w_(w), h_(h), fw_(w + 2),
      sty_(cblksty), zc_(tables().zc[orient]),
      flags_(static_cast<size_t>(w + 2) * (h + 2), 0),
      data_(static_cast<size_t>(w) * h, 0) {}

  std::vector<int32_t>& decode(const Cblk& cb, int roishift) {
    int bpno = roishift + cb.numbps;  // bpno_plus_one
    if (bpno >= 31) fail();  // "unsupported bpno_plus_one"
    int passtype = 2;
    mq_.reset_contexts();
    for (int s = 0; s < cb.numsegs; s++) {
      const Seg& sg = cb.segs[s];
      const bool raw = bpno <= cb.numbps - 4 && passtype < 2 && (sty_ & kLazy);
      if (raw)
        mq_.raw_init(sg.data.data(), sg.data.size());
      else
        mq_.init(sg.data.data(), sg.data.size());
      for (int p = 0; p < sg.numpasses && bpno >= 1; p++) {
        if (passtype == 0)
          sigpass(bpno, raw);
        else if (passtype == 1)
          refpass(bpno, raw);
        else
          clnpass(bpno);
        if ((sty_ & kReset) && !raw) mq_.reset_contexts();
        if (++passtype == 3) {
          passtype = 0;
          bpno--;
        }
      }
    }
    return data_;
  }

 private:
  static const T1Tables& tables() {
    static const T1Tables t;
    return t;
  }
  uint16_t* f(int x, int y) { return &flags_[static_cast<size_t>(y + 1) * fw_ + x + 1]; }
  int32_t& v(int x, int y) { return data_[static_cast<size_t>(y) * w_ + x]; }

  int sign(uint16_t g) {
    const int m = (g & 0xf) | ((g >> 4) & 0xf0);
    return mq_.decode(tables().sc[m]) ^ tables().sx[m];
  }
  void set_significant(int x, int y, uint16_t* g, int neg, int oneplushalf) {
    v(x, y) = neg ? -oneplushalf : oneplushalf;
    *g |= kSig;
    const int s = fw_;
    g[-1] |= static_cast<uint16_t>(kE | (neg ? kENeg : 0));
    g[1] |= static_cast<uint16_t>(kW | (neg ? kWNeg : 0));
    if (!((sty_ & kVsc) && y % 4 == 0)) {  // the stripe above sees it
      g[-s] |= static_cast<uint16_t>(kS | (neg ? kSNeg : 0));
      g[-s - 1] |= kSE;
      g[-s + 1] |= kSW;
    }
    g[s] |= static_cast<uint16_t>(kN | (neg ? kNNeg : 0));
    g[s - 1] |= kNE;
    g[s + 1] |= kNW;
  }

  void sigpass(int bpno, bool raw) {
    const int one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; x++)
        for (int y = k; y < std::min(k + 4, h_); y++) {
          uint16_t* g = f(x, y);
          if ((*g & kSig) || !(*g & kNeighbours)) continue;
          if (raw) {
            if (mq_.raw()) set_significant(x, y, g, mq_.raw(), oneplushalf);
          } else if (mq_.decode(zc_[*g & kNeighbours])) {
            set_significant(x, y, g, sign(*g), oneplushalf);
          }
          *g |= kVisit;
        }
  }
  void refpass(int bpno, bool raw) {
    const int poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; x++)
        for (int y = k; y < std::min(k + 4, h_); y++) {
          uint16_t* g = f(x, y);
          if ((*g & (kSig | kVisit)) != kSig) continue;
          const int cx = (*g & kRefined) ? 16 : (*g & kNeighbours) ? 15 : 14;
          const int bit = raw ? mq_.raw() : mq_.decode(cx);
          int32_t& c = v(x, y);
          c += (bit ^ (c < 0)) ? poshalf : -poshalf;
          *g |= kRefined;
        }
  }
  void clnpass(int bpno) {
    const int one = 1 << bpno, oneplushalf = one | (one >> 1);
    constexpr uint16_t kBusy = kNeighbours | kSig | kVisit;
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; x++) {
        int y = k;
        if (k + 4 <= h_ && !(*f(x, k) & kBusy) && !(*f(x, k + 1) & kBusy) &&
            !(*f(x, k + 2) & kBusy) && !(*f(x, k + 3) & kBusy)) {
          if (!mq_.decode(17)) continue;
          int run = mq_.decode(18) << 1;
          run |= mq_.decode(18);
          y = k + run;
          uint16_t* g = f(x, y);
          set_significant(x, y, g, sign(*g), oneplushalf);
          y++;
        }
        for (; y < std::min(k + 4, h_); y++) {
          uint16_t* g = f(x, y);
          if (*g & (kSig | kVisit)) continue;
          if (mq_.decode(zc_[*g & kNeighbours]))
            set_significant(x, y, g, sign(*g), oneplushalf);
        }
      }
    for (uint16_t& g : flags_) g &= static_cast<uint16_t>(~kVisit);
    if (sty_ & kSegSym)
      for (int i = 0; i < 4; i++) mq_.decode(18);
  }

  int w_, h_, fw_, sty_;
  const uint8_t* zc_;
  std::vector<uint16_t> flags_;
  std::vector<int32_t> data_;
  Mq mq_;
};

// ------------------------------------------------------------ HT tier 1

uint32_t le32(const uint8_t* p) {
  return uint32_t{p[0]} | uint32_t{p[1]} << 8 | uint32_t{p[2]} << 16 |
         uint32_t{p[3]} << 24;
}

// The bit readers of OpenJPEG's ht_dec.c over a code-block's bytes `b`.
// Each first reads one byte at a time up to a 4-byte boundary of the
// block's address (`align`: that address mod 4), then 4 bytes at a time;
// only MEL's first bytes check anything, so only there does the address
// change the outcome.

// The MEL decoder (dec_mel_t: mel_init, mel_read, mel_decode,
// mel_get_run): runs of zero events, forward from Lcup - Scup over Scup - 1
// bytes, the last ORed with 0xF, 0xFF past them; after 0xFF a byte gives 7
// bits, its MSB ORed onto the bit before.
struct HtMel {
  const uint8_t* b;
  int pos = 0, size = 0, k = 0, num_runs = 0;
  int bits = 0;
  bool unstuff = false;
  uint64_t tmp = 0, runs = 0;

  // false: "Incorrect MEL segment sequence" (a byte above 0x8F after an
  // 0xFF among the first 4 - address % 4)
  bool init(const uint8_t* data, int lcup, int scup, int align) {
    b = data;
    pos = lcup - scup;
    size = scup - 1;
    const int num = 4 - ((align + pos) & 3);
    for (int i = 0; i < num; ++i) {
      if (unstuff && b[pos] > 0x8f) return false;
      uint64_t d = size > 0 ? b[pos] : 0xff;
      if (size == 1) d |= 0xf;
      pos += size-- > 0;
      const int d_bits = 8 - unstuff;
      tmp = (tmp << d_bits) | d;
      bits += d_bits;
      unstuff = (d & 0xff) == 0xff;
    }
    tmp <<= (64 - bits);
    return true;
  }
  void read() {
    if (bits > 32) return;
    uint32_t val = 0xffffffffu;
    if (size > 4) {
      val = le32(b + pos);
      pos += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      while (size > 1) {
        const uint32_t v = b[pos++], m = ~(0xffu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
      const uint32_t v = b[pos++] | 0xfu, m = ~(0xffu << i);
      val = (val & m) | (v << i);
      --size;
    }
    int nbits = 32 - unstuff;
    uint32_t t = val & 0xff;
    bool u = (val & 0xff) == 0xff;
    nbits -= u;
    t = t << (8 - u);
    t |= (val >> 8) & 0xff;
    u = ((val >> 8) & 0xff) == 0xff;
    nbits -= u;
    t = t << (8 - u);
    t |= (val >> 16) & 0xff;
    u = ((val >> 16) & 0xff) == 0xff;
    nbits -= u;
    t = t << (8 - u);
    t |= (val >> 24) & 0xff;
    unstuff = ((val >> 24) & 0xff) == 0xff;
    tmp |= uint64_t{t} << (64 - nbits - bits);
    bits += nbits;
  }
  void decode() {
    static const int kExp[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
    if (bits < 6) read();
    while (bits >= 6 && num_runs < 8) {
      int eval = kExp[k];
      int run;
      if (tmp & (uint64_t{1} << 63)) {
        run = (1 << eval) - 1;
        k = k + 1 < 12 ? k + 1 : 12;
        tmp <<= 1;
        bits -= 1;
        run = run << 1;
      } else {
        run = static_cast<int>(tmp >> (63 - eval)) & ((1 << eval) - 1);
        k = k - 1 > 0 ? k - 1 : 0;
        tmp <<= eval + 1;
        bits -= eval + 1;
        run = (run << 1) + 1;
      }
      eval = num_runs * 7;
      runs &= ~(uint64_t{0x3f} << eval);
      runs |= static_cast<uint64_t>(run) << eval;
      num_runs++;
    }
  }
  int get_run() {
    if (num_runs == 0) decode();
    const int t = static_cast<int>(runs & 0x7f);
    runs >>= 7;
    num_runs--;
    return t;
  }
};

// The reverse readers (rev_struct_t): the VLC stream backward from Lcup - 3
// (rev_init, its first half byte the upper nibble at Lcup - 2) and the
// MagRef stream backward from the refinement segment's end (rev_init_mrp);
// zeros past their bytes; after a byte above 0x8F one whose 7 low bits are
// all set gives 7 bits.
struct HtRev {
  const uint8_t* b;
  int pos = 0, size = 0;
  uint32_t bits = 0;
  bool unstuff = false;
  uint64_t tmp = 0;

  void read() {
    if (bits > 32) return;
    uint32_t val = 0;
    if (size > 3) {
      val = le32(b + pos - 3);
      pos -= 4;
      size -= 4;
    } else if (size > 0) {
      int i = 24;
      while (size > 0) {
        val |= uint32_t{b[pos--]} << i;
        --size;
        i -= 8;
      }
    }
    uint32_t t = val >> 24;
    uint32_t nbits = 8u - ((unstuff && ((val >> 24) & 0x7f) == 0x7f) ? 1u : 0u);
    bool u = (val >> 24) > 0x8f;
    t |= ((val >> 16) & 0xff) << nbits;
    nbits += 8u - ((u && ((val >> 16) & 0x7f) == 0x7f) ? 1u : 0u);
    u = ((val >> 16) & 0xff) > 0x8f;
    t |= ((val >> 8) & 0xff) << nbits;
    nbits += 8u - ((u && ((val >> 8) & 0x7f) == 0x7f) ? 1u : 0u);
    u = ((val >> 8) & 0xff) > 0x8f;
    t |= (val & 0xff) << nbits;
    nbits += 8u - ((u && (val & 0x7f) == 0x7f) ? 1u : 0u);
    u = (val & 0xff) > 0x8f;
    tmp |= uint64_t{t} << bits;
    bits += nbits;
    unstuff = u;
  }
  void init_vlc(const uint8_t* data, int lcup, int scup, int align) {
    b = data;
    pos = lcup - 2;
    size = scup - 2;
    const uint32_t d = b[pos--];
    tmp = d >> 4;
    bits = 4 - ((tmp & 7) == 7);
    unstuff = (d | 0xf) > 0x8f;
    const int num = 1 + ((align + pos) & 3);
    const int tnum = num < size ? num : size;
    for (int i = 0; i < tnum; ++i) {
      const uint64_t v = b[pos--];
      const uint32_t d_bits = 8u - ((unstuff && (v & 0x7f) == 0x7f) ? 1u : 0u);
      tmp |= v << bits;
      bits += d_bits;
      unstuff = v > 0x8f;
    }
    size -= tnum;
    read();
  }
  void init_mrp(const uint8_t* data, int lcup, int len2, int align) {
    b = data;
    pos = lcup + len2 - 1;
    size = len2;
    unstuff = true;
    const int num = 1 + ((align + pos) & 3);
    for (int i = 0; i < num; ++i) {
      const uint64_t v = size-- > 0 ? b[pos--] : 0;
      const uint32_t d_bits = 8u - ((unstuff && (v & 0x7f) == 0x7f) ? 1u : 0u);
      tmp |= v << bits;
      bits += d_bits;
      unstuff = v > 0x8f;
    }
    read();
  }
  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return static_cast<uint32_t>(tmp);
  }
  uint32_t advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
    return static_cast<uint32_t>(tmp);
  }
};

// The forward reader (frwd_struct_t): MagSgn from the block's start over
// Lcup - Scup bytes, 0xFF past them; SigProp from the refinement segment's
// start, zeros past it; after 0xFF a byte gives 7 bits.
struct HtFrwd {
  const uint8_t* b;
  int pos = 0, size = 0;
  uint32_t bits = 0, x = 0;
  bool unstuff = false;
  uint64_t tmp = 0;

  void read() {
    uint32_t val;
    if (size > 3) {
      val = le32(b + pos);
      pos += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      val = x != 0 ? 0xffffffffu : 0;
      while (size > 0) {
        const uint32_t v = b[pos++], m = ~(0xffu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
    } else {
      val = x != 0 ? 0xffffffffu : 0;
    }
    uint32_t nbits = 8u - (unstuff ? 1u : 0u);
    uint32_t t = val & 0xff;
    bool u = (val & 0xff) == 0xff;
    t |= ((val >> 8) & 0xff) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    u = ((val >> 8) & 0xff) == 0xff;
    t |= ((val >> 16) & 0xff) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    u = ((val >> 16) & 0xff) == 0xff;
    t |= ((val >> 24) & 0xff) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    unstuff = ((val >> 24) & 0xff) == 0xff;
    tmp |= uint64_t{t} << bits;
    bits += nbits;
  }
  void init(const uint8_t* data, int start, int n, uint32_t fill, int align) {
    b = data;
    pos = start;
    size = n;
    x = fill;
    const int num = 4 - ((align + start) & 3);
    for (int i = 0; i < num; ++i) {
      const uint64_t d = size-- > 0 ? b[pos++] : x;
      tmp |= d << bits;
      bits += 8u - (unstuff ? 1u : 0u);
      unstuff = (d & 0xff) == 0xff;
    }
    read();
  }
  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return static_cast<uint32_t>(tmp);
  }
  void advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
  }
};

// The UVLC prefix codes by their next 3 bits (LSB first): the prefix's
// length (bits 0-1), the suffix's length (bits 2-4), u_pfx (bits 5-7).
constexpr uint8_t kUvlc[8] = {
    3 | (5 << 2) | (5 << 5), 1 | (0 << 2) | (1 << 5), 2 | (0 << 2) | (2 << 5),
    1 | (0 << 2) | (1 << 5), 3 | (1 << 2) | (3 << 5), 1 | (0 << 2) | (1 << 5),
    2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5)};

// decode_init_uvlc: u + kappa (1) of a quad pair of the first row pair by
// its u_off bits (`mode` 1, 2, 3; 4 where both are set and the MEL event is
// 1, which adds 2); with both set and the first prefix past 2 the second
// quad's u is one bit. Returns the bits taken.
uint32_t decode_init_uvlc(uint32_t vlc, uint32_t mode, uint32_t* u) {
  uint32_t consumed = 0;
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    uint32_t d = kUvlc[vlc & 7];
    vlc >>= d & 3;
    consumed += d & 3;
    const uint32_t suffix = (d >> 2) & 7;
    consumed += suffix;
    d = (d >> 5) + (vlc & ((1u << suffix) - 1));
    u[0] = mode == 1 ? d + 1 : 1;
    u[1] = mode == 1 ? 1 : d + 1;
  } else if (mode == 3) {
    uint32_t d1 = kUvlc[vlc & 7];
    vlc >>= d1 & 3;
    consumed += d1 & 3;
    if ((d1 & 3) > 2) {
      u[1] = (vlc & 1) + 1 + 1;
      ++consumed;
      vlc >>= 1;
      const uint32_t suffix = (d1 >> 2) & 7;
      consumed += suffix;
      d1 = (d1 >> 5) + (vlc & ((1u << suffix) - 1));
      u[0] = d1 + 1;
    } else {
      uint32_t d2 = kUvlc[vlc & 7];
      vlc >>= d2 & 3;
      consumed += d2 & 3;
      uint32_t suffix = (d1 >> 2) & 7;
      consumed += suffix;
      d1 = (d1 >> 5) + (vlc & ((1u << suffix) - 1));
      u[0] = d1 + 1;
      vlc >>= suffix;
      suffix = (d2 >> 2) & 7;
      consumed += suffix;
      d2 = (d2 >> 5) + (vlc & ((1u << suffix) - 1));
      u[1] = d2 + 1;
    }
  } else if (mode == 4) {
    uint32_t d1 = kUvlc[vlc & 7];
    vlc >>= d1 & 3;
    consumed += d1 & 3;
    uint32_t d2 = kUvlc[vlc & 7];
    vlc >>= d2 & 3;
    consumed += d2 & 3;
    uint32_t suffix = (d1 >> 2) & 7;
    consumed += suffix;
    d1 = (d1 >> 5) + (vlc & ((1u << suffix) - 1));
    u[0] = d1 + 3;
    vlc >>= suffix;
    suffix = (d2 >> 2) & 7;
    consumed += suffix;
    d2 = (d2 >> 5) + (vlc & ((1u << suffix) - 1));
    u[1] = d2 + 3;
  }
  return consumed;
}

// decode_noninit_uvlc: the same for the later row pairs (no MEL event, no
// one-bit rule).
uint32_t decode_noninit_uvlc(uint32_t vlc, uint32_t mode, uint32_t* u) {
  uint32_t consumed = 0;
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    uint32_t d = kUvlc[vlc & 7];
    vlc >>= d & 3;
    consumed += d & 3;
    const uint32_t suffix = (d >> 2) & 7;
    consumed += suffix;
    d = (d >> 5) + (vlc & ((1u << suffix) - 1));
    u[0] = mode == 1 ? d + 1 : 1;
    u[1] = mode == 1 ? 1 : d + 1;
  } else if (mode == 3) {
    uint32_t d1 = kUvlc[vlc & 7];
    vlc >>= d1 & 3;
    consumed += d1 & 3;
    uint32_t d2 = kUvlc[vlc & 7];
    vlc >>= d2 & 3;
    consumed += d2 & 3;
    uint32_t suffix = (d1 >> 2) & 7;
    consumed += suffix;
    d1 = (d1 >> 5) + (vlc & ((1u << suffix) - 1));
    u[0] = d1 + 1;
    vlc >>= suffix;
    suffix = (d2 >> 2) & 7;
    consumed += suffix;
    d2 = (d2 >> 5) + (vlc & ((1u << suffix) - 1));
    u[1] = d2 + 1;
  }
  return consumed;
}

uint32_t popcount32(uint32_t v) { return static_cast<uint32_t>(__builtin_popcount(v)); }
uint32_t bit_length(uint32_t v) { return 32u - static_cast<uint32_t>(__builtin_clz(v)); }

// One HT code-block (opj_t1_ht_decode_cblk), in OpenJPEG's doubled scale
// like T1's: a cleanup sample of magnitude mu holds (2 mu + 1) << (p - 1)
// for p = numbps, the refinement passes working one bit-plane lower, sign
// and magnitude until the end. Fail() where OpenJPEG fails the decode: ROI,
// more than 3 passes, Mb over 30, more zero bit-planes than Mb, the
// segments' lengths, Scup, the MEL stream's first bytes, a U_q past the
// zero bit-planes + 1, a VLC codeword that makes a sample outside the
// block significant. The refinement passes are dropped and the block
// decoded on (OpenJPEG only warns) where the second segment is empty or
// the zero bit-planes equal Mb.
//
// OpenJPEG runs the SigProp and MagRef passes of each stripe of 4 rows
// inside the cleanup's loop, once the rows below it are decoded; they read
// streams of their own and only the cleanup's significance, so here they
// run after it, stripe by stripe in the same order, over every stripe's
// significance kept (sigma: 4 rows a nibble, 8 columns a word).
class HtBlock {
 public:
  HtBlock(int w, int h, int cblksty)
      : w_(w), h_(h), causal_((cblksty & kVsc) != 0),
        stripes_((h + 3) / 4), data_(static_cast<size_t>(w) * h, 0),
        sigma_(static_cast<size_t>(stripes_ + 1) * kWords, 0),
        mbr_(static_cast<size_t>(stripes_ + 1) * kWords, 0) {}

  std::vector<int32_t>& decode(const Cblk& cb, int roishift) {
    if (roishift != 0) fail();  // "We do not support ROI in decoding HT codeblocks"
    const uint32_t mb = cb.mb;
    if (mb == 0) return data_;
    const uint32_t zero_bplanes = mb + 1 - static_cast<uint32_t>(cb.numbps);
    if (cb.numchunks == 0) return data_;
    // every piece of the block's data, in the order they came; a block of
    // one piece is read in place in the tile's data, one of more in a
    // buffer of its own (malloc'd, its address a multiple of 4)
    std::vector<uint8_t> coded;
    for (int s = 0; s < cb.numsegs; s++)
      coded.insert(coded.end(), cb.segs[s].data.begin(), cb.segs[s].data.end());
    const int align = cb.numchunks == 1 ? static_cast<int>(cb.chunk0 & 3) : 0;
    const uint32_t cblk_len = static_cast<uint32_t>(coded.size());
    const auto seg_len = [&](int k) {
      return k < cb.numsegs ? static_cast<uint32_t>(cb.segs[k].data.size()) : 0u;
    };
    uint32_t num_passes = cb.numsegs > 0 ? static_cast<uint32_t>(cb.segs[0].numpasses) : 0;
    num_passes += cb.numsegs > 1 ? static_cast<uint32_t>(cb.segs[1].numpasses) : 0;
    const uint32_t lengths1 = num_passes > 0 ? seg_len(0) : 0;
    const uint32_t lengths2 = num_passes > 1 ? seg_len(1) : 0;
    if (num_passes > 1 && lengths2 == 0) num_passes = 1;  // "zero length for 2nd ... pass"
    if (num_passes > 3) fail();  // "more than 3 coding passes in an HT codeblock"
    if (mb > 30) fail();         // "32 bits are not enough"
    if (zero_bplanes > mb) fail();  // "There are %d zero bitplanes in %d bitplanes"
    if (zero_bplanes == mb && num_passes > 1) num_passes = 1;  // "only the cleanup pass"
    const uint32_t p = static_cast<uint32_t>(cb.numbps);
    if (lengths1 < 2 || lengths1 > cblk_len || lengths1 + lengths2 > cblk_len)
      fail();  // "Invalid codeblock length values"
    const uint8_t* cd = coded.data();
    const int lcup = static_cast<int>(lengths1);
    const int scup = (int{cd[lcup - 1]} << 4) + (cd[lcup - 2] & 0xf);
    if (scup < 2 || scup > lcup || scup > 4079) fail();  // "2 <= Scup <= min(Lcup, 4079)"
    HtMel mel;
    if (!mel.init(cd, lcup, scup, align)) fail();  // "Incorrect MEL segment sequence"
    HtRev vlc;
    vlc.init_vlc(cd, lcup, scup, align);
    HtFrwd magsgn;
    magsgn.init(cd, 0, lcup - scup, 0xff, align);
    HtFrwd sigprop;
    HtRev magref;
    if (num_passes > 1) sigprop.init(cd, lcup, static_cast<int>(lengths2), 0, align);
    if (num_passes > 2) magref.init_mrp(cd, lcup, static_cast<int>(lengths2), align);
    cleanup(mel, vlc, magsgn, p, zero_bplanes + 1);
    if (num_passes > 1) {
      for (int s = 0; s < stripes_; s++) {
        if (num_passes > 2) magref_pass(magref, s, p);
        membership(s);
      }
      for (int s = 0; s < stripes_; s++) sigprop_pass(sigprop, s, p);
    }
    for (int32_t& v : data_) {
      const uint32_t u = static_cast<uint32_t>(v);
      const int32_t mag = static_cast<int32_t>(u & 0x7fffffffu);
      v = (u & 0x80000000u) ? -mag : mag;
    }
    return data_;
  }

 private:
  static constexpr int kWords = 132;  // a stripe's words of 8 columns, and room

  uint32_t get(int x, int y) const {
    return static_cast<uint32_t>(data_[static_cast<size_t>(y) * w_ + x]);
  }
  void set(int x, int y, uint32_t v) {
    data_[static_cast<size_t>(y) * w_ + x] = static_cast<int32_t>(v);
  }
  uint32_t* sig(int s) { return &sigma_[static_cast<size_t>(s) * kWords]; }
  uint32_t* mbr(int s) { return &mbr_[static_cast<size_t>(s) * kWords]; }

  // a significant sample's MagSgn bits: m_n of them (the sign their LSB),
  // e_1 above them, the bin's centre below; `k` the sample's place in its
  // quad (0-3, column by column). Returns v_n.
  static uint32_t magsgn(HtFrwd& ms, uint32_t qinf, int k, uint32_t uq,
                         uint32_t p, uint32_t& out) {
    const uint32_t ms_val = ms.fetch();
    const uint32_t m_n = uq - ((qinf >> (12 + k)) & 1);
    ms.advance(m_n);
    uint32_t v_n = ms_val & ((1u << m_n) - 1);
    v_n |= ((qinf >> (8 + k)) & 1) << m_n;
    v_n |= 1;
    out = (ms_val << 31) | ((v_n + 2) << (p - 1));
    return v_n;
  }

  // The cleanup pass, a row pair at a time: the first (kHtVlc0, a MEL
  // event for a zero context and for two u_off, decode_init_uvlc), then
  // the rest (kHtVlc1, contexts and kappa from the line state: a byte a
  // quad of the row above, bit 7 sigma^NW | sigma^N, below it max(E^NW,
  // E^N)).
  void cleanup(HtMel& mel, HtRev& vlc, HtFrwd& ms, uint32_t p,
               uint32_t zero_bplanes_p1) {
    int run = mel.get_run();
    uint8_t* const ls = line_state_;
    for (int y = 0; y < h_; y += 2) {
      const bool initial = y == 0;
      uint32_t* sg = sig(y >> 2);
      uint8_t* lsp = ls;
      uint8_t ls0 = lsp[0];
      lsp[0] = 0;
      uint32_t c_q = 0;
      for (int x = 0; x < w_; x += 4) {
        uint32_t qinf[2] = {0, 0}, u_q[2];
        const uint16_t* tbl = initial ? kHtVlc0 : kHtVlc1;
        uint32_t vlc_val = vlc.fetch();
        for (int q = 0; q < 2; q++) {
          if (q == 1 && x + 2 >= w_) break;
          if (!initial) {
            c_q |= (q == 0 ? ls0 : lsp[1]) >> 7;
            c_q |= (lsp[q + 1] >> 5) & 0x4;
          }
          qinf[q] = tbl[(c_q << 7) | (vlc_val & 0x7f)];
          if (c_q == 0) {  // a MEL event: 1 keeps the codeword
            run -= 2;
            qinf[q] = run == -1 ? qinf[q] : 0;
            if (run < 0) run = mel.get_run();
          }
          c_q = initial ? ((qinf[q] & 0x10) >> 4) | ((qinf[q] & 0xe0) >> 5)
                        : ((qinf[q] & 0x40) >> 5) | ((qinf[q] & 0x80) >> 6);
          vlc_val = vlc.advance(qinf[q] & 0x7);
        }
        const uint32_t shift = ((x & 4) ? 16u : 0u) + static_cast<uint32_t>(y & 2);
        sg[x >> 3] |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xc0) >> 2)) << shift;
        sg[x >> 3] |= ((qinf[1] & 0x30) | ((qinf[1] & 0xc0) << 2)) << (4 + shift);
        uint32_t mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
        if (initial) {
          if (mode == 3) {  // both u_off: a MEL event, 1 adds 2 to each u
            run -= 2;
            mode += run == -1 ? 1 : 0;
            if (run < 0) run = mel.get_run();
          }
          vlc_val = vlc.advance(decode_init_uvlc(vlc_val, mode, u_q));
          if (u_q[0] > zero_bplanes_p1 || u_q[1] > zero_bplanes_p1)
            fail();  // "U_q is larger than zero bitplanes + 1"
        } else {
          vlc_val = vlc.advance(decode_noninit_uvlc(vlc_val, mode, u_q));
          // kappa of a quad of two or more significant samples:
          // max(E^NW, E^N, E^NE, E^NF) - 1 past 1
          if ((qinf[0] & 0xf0) & ((qinf[0] & 0xf0) - 1)) {
            const uint32_t e = std::max<uint32_t>(ls0 & 0x7f, lsp[1] & 0x7f);
            u_q[0] += e > 2 ? e - 2 : 0;
          }
          if ((qinf[1] & 0xf0) & ((qinf[1] & 0xf0) - 1)) {
            const uint32_t e = std::max<uint32_t>(lsp[1] & 0x7f, lsp[2] & 0x7f);
            u_q[1] += e > 2 ? e - 2 : 0;
          }
          if (u_q[0] > zero_bplanes_p1 || u_q[1] > zero_bplanes_p1)
            fail();  // "U_q islarger than bitplanes + 1"
          ls0 = lsp[2];
          lsp[1] = lsp[2] = 0;
        }
        uint32_t locs = 0xff;
        if (x + 4 > w_) locs >>= (x + 4 - w_) << 1;
        if (y + 2 > h_) locs &= 0x55;
        if ((((qinf[0] & 0xf0) >> 4) | (qinf[1] & 0xf0)) & ~locs)
          fail();  // "VLC code produces significant samples outside the codeblock area"
        // the samples column by column, (x, y), (x, y + 1), (x + 1, y), ...;
        // the second row's exponents E = bit_length(v_n) into the line
        // state: max(E^NW, E^N) at a quad's first column, E^NW at its second
        for (int col = 0; col < 4; col++) {
          const uint32_t qi = qinf[col >> 1];
          const int k = 2 * (col & 1);  // the column's top sample in its quad
          const uint32_t at = 1u << (2 * col);
          uint32_t v;
          if (qi & (0x10u << k)) {
            magsgn(ms, qi, k, u_q[col >> 1], p, v);
            set(x + col, y, v);
          } else if (locs & at) {
            set(x + col, y, 0);
          }
          if (qi & (0x20u << k)) {
            const uint32_t e = bit_length(magsgn(ms, qi, k + 1, u_q[col >> 1], p, v));
            set(x + col, y + 1, v);
            const uint32_t t = col & 1 ? 0 : lsp[0] & 0x7f;
            lsp[0] = static_cast<uint8_t>(0x80 | (t > e ? t : e));
          } else if (locs & (at << 1)) {
            set(x + col, y + 1, 0);
          }
          if (!(col & 1)) ++lsp;
        }
      }
    }
  }

  // MagRef over stripe s (rows 4s..): a bit a cleanup-significant sample,
  // 8 columns at a time, column by column; 0 takes the bin's centre back
  // down, both add half of it.
  void magref_pass(HtRev& mrp, int s, uint32_t p) {
    const uint32_t half = 1u << (p - 2);
    const uint32_t* cur = sig(s);
    for (int i = 0; i < w_; i += 8) {
      uint32_t cwd = mrp.fetch();
      const uint32_t sg = *cur++;
      if (sg)
        for (int j = 0; j < 8; j++)
          for (int r = 0; r < 4; r++) {
            if (!(sg & (1u << (4 * j + r)))) continue;
            const int x = i + j, y = 4 * s + r;
            uint32_t v = get(x, y);
            v ^= (1 - (cwd & 1)) << (p - 1);
            v |= half;
            set(x, y, v);
            cwd >>= 1;
          }
      mrp.advance(popcount32(sg));
    }
  }

  // a stripe's membership within itself: the 8 neighbours of its
  // significant samples, less those samples
  void membership(int s) {
    const uint32_t* sg = sig(s);
    uint32_t* m = mbr(s);
    uint32_t prev = 0;
    for (int i = 0; i < w_; i += 8, m++, sg++) {
      m[0] = sg[0];
      m[0] |= prev >> 28;
      m[0] |= sg[0] << 4;
      m[0] |= sg[0] >> 4;
      m[0] |= sg[1] << 28;
      prev = sg[0];
      const uint32_t t = m[0];
      uint32_t z = m[0];
      z |= (t & 0x77777777u) << 1;
      z |= (t & 0xeeeeeeeeu) >> 1;
      m[0] = z & ~sg[0];
    }
  }

  // SigProp over stripe s: the stripe below's cleanup significance joins
  // its membership (not under VSC), then 4 columns at a time a bit for
  // each member (column by column; one that becomes significant spreads
  // to the members after it) and the signs of the new ones; the new ones
  // and the stripe's own spread to the next stripe's top row.
  void sigprop_pass(HtFrwd& spp, int s, uint32_t p) {
    const int y0 = 4 * s, rows = std::min(4, h_ - y0);
    const uint32_t pattern = rows == 4 ? 0xffffffffu : rows == 3 ? 0x77777777u
                             : rows == 2 ? 0x33333333u : 0x11111111u;
    if (s + 1 < stripes_) {
      uint32_t prev = 0;
      uint32_t *cur_sig = sig(s), *cur_mbr = mbr(s), *nxt_sig = sig(s + 1);
      for (int i = 0; i < w_; i += 8, cur_mbr++, cur_sig++, nxt_sig++) {
        uint32_t t = nxt_sig[0];
        t |= prev >> 28;
        t |= nxt_sig[0] << 4;
        t |= nxt_sig[0] >> 4;
        t |= nxt_sig[1] << 28;
        prev = nxt_sig[0];
        if (!causal_) cur_mbr[0] |= (t & 0x11111111u) << 3;
        cur_mbr[0] &= ~cur_sig[0];
      }
    }
    const uint32_t val = 3u << (p - 2);
    uint32_t *cur_sig = sig(s), *cur_mbr = mbr(s);
    uint32_t *nxt_sig = sig(s + 1), *nxt_mbr = mbr(s + 1);
    for (int i = 0; i < w_; i += 8, cur_sig++, cur_mbr++, nxt_sig++, nxt_mbr++) {
      uint32_t members = *cur_mbr & pattern;
      uint32_t new_sig = 0;
      if (members) {
        for (int n = 0; n < 8; n += 4) {
          uint32_t cwd = spp.fetch();
          uint32_t cnt = 0;
          const uint32_t inv_sig = ~cur_sig[0] & pattern;
          const int end = n + 4 + i < w_ ? n + 4 : w_ - i;
          for (int j = n; j < end; ++j) {
            if (((0xfu << (4 * j)) & members) == 0) continue;
            static const uint32_t kSpread[4] = {0x32u, 0x74u, 0xe8u, 0xc0u};
            for (int r = 0; r < 4; r++) {
              const uint32_t sample = 1u << (4 * j + r);
              if (!(members & sample)) continue;
              if (cwd & 1) {
                new_sig |= sample;
                members |= (kSpread[r] << (j * 4)) & inv_sig;
              }
              cwd >>= 1;
              ++cnt;
            }
          }
          if (new_sig & (0xffffu << (4 * n))) {
            for (int j = n; j < end; ++j) {
              if (((0xfu << (4 * j)) & new_sig) == 0) continue;
              for (int r = 0; r < 4; r++) {
                if (!(new_sig & (1u << (4 * j + r)))) continue;
                const int x = i + j, y = y0 + r;
                set(x, y, get(x, y) | ((cwd & 1) << 31) | val);
                cwd >>= 1;
                ++cnt;
              }
            }
          }
          spp.advance(cnt);
          if (n == 4) {  // the next 8 columns' first
            uint32_t t = new_sig >> 28;
            t |= ((t & 0xe) >> 1) | ((t & 7) << 1);
            cur_mbr[1] |= t & ~cur_sig[1];
          }
        }
      }
      new_sig |= cur_sig[0];
      const uint32_t ux = (new_sig & 0x88888888u) >> 3;
      const uint32_t tx = ux | (ux << 4) | (ux >> 4);
      if (i > 0) nxt_mbr[-1] |= (ux << 28) & ~nxt_sig[-1];
      nxt_mbr[0] |= tx & ~nxt_sig[0];
      nxt_mbr[1] |= (ux >> 28) & ~nxt_sig[1];
    }
  }

  int w_, h_;
  bool causal_;
  int stripes_;
  std::vector<int32_t> data_;
  std::vector<uint32_t> sigma_, mbr_;  // a stripe's kWords each, one spare
  uint8_t line_state_[528] = {};
};

// ------------------------------------------------------------ transforms

int mirror(int k, int n) {
  if (k < 0) k = -k;
  if (k >= n) k = 2 * n - 2 - k;
  return k;
}

// The inverse 5/3 of one interleaved line (cas: the line starts with a
// high-pass sample).
void idwt53(int32_t* x, int n, int cas) {
  if (n == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  for (int i = cas; i < n; i += 2)
    x[i] -= (x[mirror(i - 1, n)] + x[mirror(i + 1, n)] + 2) >> 2;
  for (int i = 1 - cas; i < n; i += 2)
    x[i] += (x[mirror(i - 1, n)] + x[mirror(i + 1, n)]) >> 1;
}

// The inverse 9/7 of one line as opj_v8dwt_decode computes it: lows times
// K, highs times 2/K's historic 1.625732422, then the four lifting steps,
// each x + ((left + right) * c) in float.
void idwt97(float* x, int n, int cas) {
  if (n == 1) return;
  constexpr float kK = 1.230174105f, kTwoInvK = 1.625732422f;
  constexpr float kAlpha = -1.586134342f, kBeta = -0.052980118f,
                  kGamma = 0.882911075f, kDelta = 0.443506852f;
  for (int i = cas; i < n; i += 2) x[i] = x[i] * kK;
  for (int i = 1 - cas; i < n; i += 2) x[i] = x[i] * kTwoInvK;
  auto lift = [&](int first, float c) {
    for (int i = first; i < n; i += 2)
      x[i] = x[i] + ((x[mirror(i - 1, n)] + x[mirror(i + 1, n)]) * c);
  };
  lift(cas, -kDelta);
  lift(1 - cas, -kGamma);
  lift(cas, -kBeta);
  lift(1 - cas, -kAlpha);
}

// The inverse transform up to resolution tc.rd (opj_dwt_decode with
// resno_decoded + 1 resolutions).
template <typename T, typename F>
void idwt2d(TileComp& tc, T* buf, F line) {
  const int stride = tc.w();
  std::vector<T> tmp;
  for (int r = 1; r <= tc.rd; r++) {
    const Res& lo = tc.res[r - 1];
    const Res& res = tc.res[r];
    const int rw = res.x1 - res.x0, rh = res.y1 - res.y0;
    const int snh = lo.x1 - lo.x0, snv = lo.y1 - lo.y0;
    const int cash = res.x0 & 1, casv = res.y0 & 1;
    tmp.resize(std::max(rw, rh));
    if (rw > 0)
      for (int y = 0; y < rh; y++) {
        T* row = buf + static_cast<size_t>(y) * stride;
        for (int i = 0; i < snh; i++) tmp[2 * i + cash] = row[i];
        for (int i = 0; i < rw - snh; i++) tmp[2 * i + 1 - cash] = row[snh + i];
        line(tmp.data(), rw, cash);
        std::copy(tmp.begin(), tmp.begin() + rw, row);
      }
    if (rh > 0)
      for (int x = 0; x < rw; x++) {
        T* col = buf + x;
        for (int i = 0; i < snv; i++) tmp[2 * i + casv] = col[static_cast<size_t>(i) * stride];
        for (int i = 0; i < rh - snv; i++)
          tmp[2 * i + 1 - casv] = col[static_cast<size_t>(snv + i) * stride];
        line(tmp.data(), rh, casv);
        for (int i = 0; i < rh; i++) col[static_cast<size_t>(i) * stride] = tmp[i];
      }
  }
}

// opj_tcd_decode_tile: tier 2, tier 1, the inverse transforms, the MCT and
// the DC level shift; the samples land in each component's idata, those of
// resolution rd (every resolution where every packet was read) at its top
// left, zeros around them.
void decode_tile(Codestream& cs, const Tcp& tcp, int tileno,
                 std::vector<TileComp>& tile, HeaderStore* store) {
  const int p = tileno % cs.tw, q = tileno / cs.tw;
  const int tx0 = static_cast<int>(std::max<int64_t>(cs.tx0 + int64_t{p} * cs.tdx, cs.x0));
  const int ty0 = static_cast<int>(std::max<int64_t>(cs.ty0 + int64_t{q} * cs.tdy, cs.y0));
  const int tx1 = static_cast<int>(std::min<int64_t>(cs.tx0 + int64_t{p + 1} * cs.tdx, cs.x1));
  const int ty1 = static_cast<int>(std::min<int64_t>(cs.ty0 + int64_t{q + 1} * cs.tdy, cs.y1));
  if (tx0 >= tx1 || ty0 >= ty1) fail();
  if (int64_t{tx1 - tx0} * (ty1 - ty0) * static_cast<int64_t>(cs.comps.size()) >
      (int64_t{1} << 31))
    fail();
  init_tile(cs, tcp, tx0, ty0, tx1, ty1, tile);
  decode_packets(tcp, tx0, ty0, tx1, ty1, tile, tcp.data, store,
                 cs.resno_decoded);
  for (size_t c = 0; c < tile.size(); c++) {
    TileComp& tc = tile[c];
    const Tccp& tccp = tcp.tccps[c];
    tc.rd = cs.resno_decoded[c];
    if (tc.rd >= tc.numres) fail();  // past this tile's resolutions
    const int stride = tc.w();
    for (int r = 0; r < tc.numres; r++) {
      Res& res = tc.res[r];
      for (int b = 0; b < res.numbands; b++) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        for (Prc& prc : band.prcs)
          for (Cblk& cb : prc.cblks) {
            const int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
            if (w <= 0 || h <= 0) continue;
            // opj_t1_clbl_decode_processor: the HT decoder for a block of
            // the HT style, T1 for the rest
            std::unique_ptr<HtBlock> ht;
            std::unique_ptr<T1> t1;
            if (tccp.cblksty & kHt)
              ht = std::make_unique<HtBlock>(w, h, tccp.cblksty);
            else
              t1 = std::make_unique<T1>(w, h, band.bandno, tccp.cblksty);
            std::vector<int32_t>& d = ht ? ht->decode(cb, tccp.roishift)
                                         : t1->decode(cb, tccp.roishift);
            // opj_t1_clbl_decode_processor's ROI: magnitudes at or above
            // 1 << roishift scaled down by it (every one zeroed past 30)
            if (tccp.roishift >= 31) {
              std::fill(d.begin(), d.end(), 0);
            } else if (tccp.roishift) {
              const int32_t thresh = int32_t{1} << tccp.roishift;
              for (int32_t& q : d) {
                const int32_t mag = q < 0 ? -q : q;
                if (mag >= thresh) q = q < 0 ? -(mag >> tccp.roishift) : mag >> tccp.roishift;
              }
            }
            int x = cb.x0 - band.x0, y = cb.y0 - band.y0;
            if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
            if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
            if (tccp.qmfbid == 1) {
              for (int j = 0; j < h; j++)
                for (int i = 0; i < w; i++)
                  tc.idata[static_cast<size_t>(y + j) * stride + x + i] =
                      d[static_cast<size_t>(j) * w + i] / 2;
            } else {
              const float step = 0.5f * band.stepsize;
              for (int j = 0; j < h; j++)
                for (int i = 0; i < w; i++)
                  tc.fdata[static_cast<size_t>(y + j) * stride + x + i] =
                      static_cast<float>(d[static_cast<size_t>(j) * w + i]) * step;
            }
          }
      }
    }
    if (tccp.qmfbid == 1)
      idwt2d(tc, tc.idata.data(), idwt53);
    else
      idwt2d(tc, tc.fdata.data(), idwt97);
  }
  const size_t area = static_cast<size_t>(tx1 - tx0) * (ty1 - ty0);
  if (tcp.mct == 1 && tile.size() >= 3) {
    const int q0 = tcp.tccps[0].qmfbid;
    if (tcp.tccps[1].qmfbid != q0 || tcp.tccps[2].qmfbid != q0) unsupported();
    if (q0 == 1) {
      int32_t *c0 = tile[0].idata.data(), *c1 = tile[1].idata.data(),
              *c2 = tile[2].idata.data();
      for (size_t i = 0; i < area; i++) {
        const int32_t y = c0[i], u = c1[i], v = c2[i];
        const int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {
      float *c0 = tile[0].fdata.data(), *c1 = tile[1].fdata.data(),
            *c2 = tile[2].fdata.data();
      for (size_t i = 0; i < area; i++) {
        const float y = c0[i], u = c1[i], v = c2[i];
        const float r = y + (v * 1.402f);
        float g = y - (u * 0.34413f);
        g = g - (v * 0.71414f);
        const float b = y + (u * 1.772f);
        c0[i] = r;
        c1[i] = g;
        c2[i] = b;
      }
    }
  }
  for (size_t c = 0; c < tile.size(); c++) {
    TileComp& tc = tile[c];
    const CompInfo& ci = cs.comps[c];
    const int32_t lo = ci.sgnd ? -(1 << (ci.prec - 1)) : 0;
    const int32_t hi = ci.sgnd ? (1 << (ci.prec - 1)) - 1
                               : static_cast<int32_t>((int64_t{1} << ci.prec) - 1);
    const int32_t shift = tcp.tccps[c].dc_shift;
    const int ow = tc.out_w(), oh = tc.out_h(), stride = tc.w();
    if (tcp.tccps[c].qmfbid == 1) {
      // the 5/3's sum in int32, wrapping as OpenJPEG's does
      for (int y = 0; y < oh; y++)
        for (int x = 0; x < ow; x++) {
          int32_t& v = tc.idata[static_cast<size_t>(y) * stride + x];
          v = std::clamp(static_cast<int32_t>(static_cast<uint32_t>(v) +
                                              static_cast<uint32_t>(shift)),
                         lo, hi);
        }
    } else {
      tc.idata.assign(area, 0);
      for (int y = 0; y < oh; y++)
        for (int x = 0; x < ow; x++) {
          const size_t i = static_cast<size_t>(y) * stride + x;
          const float v = tc.fdata[i];
          int32_t out;
          if (v > static_cast<float>(INT32_MAX)) {
            out = hi;
          } else if (v < static_cast<float>(INT32_MIN)) {
            out = lo;
          } else {
            out = static_cast<int32_t>(std::clamp<int64_t>(
                static_cast<int64_t>(std::lrintf(v)) + shift, lo, hi));
          }
          tc.idata[i] = out;
        }
      std::vector<float>().swap(tc.fdata);
    }
  }
}

// ------------------------------------------------------ the tile stream

// opj_j2k's decoder over the codestream: the main header, then tile-parts
// read and tiles decoded as opj_j2k_read_tile_header and
// opj_j2k_decode_tiles take them (strict mode, OpenJPEG 2.5's default).
class J2k {
 public:
  Jp2Info jp2;
  Codestream cs;
  int color_space = kCsUnspecified;

  // The JP2 boxes (a file that starts with the JP2 signature) and the main
  // header; throws Fail where opj_read_header fails.
  void read_header(const uint8_t* d, size_t n) {
    if (n >= 12 && !std::memcmp(d, "\0\0\0\x0cjP  \r\n\x87\n", 12)) {
      jp2.jp2 = true;
      boxes_.walk(d, n, 0, false);
      if (jp2.codestream == 0 || !jp2.has_jp2h) fail();  // "JP2H box missing"
      // opj_jp2_read_header: CIELab, an ICC profile and any other EnumCS
      // are unknown
      const uint32_t e = jp2.enumcs;
      color_space = e == 16 ? kCsSrgb : e == 17 ? kCsGray : e == 18 ? kCsSycc
                    : e == 24 ? kCsEycc : e == 12 ? kCsCmyk : kCsUnknown;
    }
    s_ = Stream{d + jp2.codestream, n - jp2.codestream};
    read_main_header(s_, cs, state_, jp2);
  }

  // Every tile (opj_decode over cv2's file stream: it stops after the last
  // tile; Pillow's tile API, `tile_api`, over a stream without seek, reads
  // on to the codestream's end), each handed to `put` once decoded.
  template <typename Put>
  void decode(bool tile_api, Put put) {
    seekable_ = !tile_api;
    const int ntiles = cs.tw * cs.th;
    int nb_read = 0;
    std::vector<TileComp> tile;
    for (;;) {
      int tileno;
      if (!read_tile_header(tileno)) break;
      Tcp& tcp = cs.tcps[tileno];
      if (!tcp.has_data) fail();
      if (tcp.ppt) merge_ppt(tcp.ppt_store);
      decode_tile(cs, tcp, tileno, tile,
                  cs.ppm ? &cs.ppm_store : tcp.ppt ? &tcp.ppt_store : nullptr);
      put(tile);
      std::vector<uint8_t>().swap(tcp.data);
      tcp.has_data = false;
      can_decode_ = false;
      state_ &= ~kData;
      if (!(s_.left() == 0 && state_ == kNeoc) && state_ != kEoc) {
        uint32_t m;
        if (!s_.read16(m)) fail();  // "Stream too short"
        if (m == kEOC) {
          current_ = 0;
          state_ = kEoc;
        } else if (m != kSOT) {
          if (s_.left() != 0) fail();  // "Stream too short, expected SOT"
          state_ = kNeoc;  // "Stream does not end with EOC"
        }
      }
      if (tile_api) continue;  // the next opj_read_tile_header decides
      if (s_.left() == 0 && state_ == kNeoc) break;
      if (++nb_read == ntiles) break;
    }
  }

  // opj_jp2_end_decompress: the boxes after the codestream.
  void end_jp2(const uint8_t* d, size_t n) {
    boxes_.walk(d, n, jp2.codestream + s_.pos, true);
  }

 private:
  bool read_tile_header(int& tileno) {
    uint32_t marker = kSOT;
    if (state_ == kEoc)
      marker = kEOC;
    else if (state_ != kTphSot)
      fail();
    std::vector<uint8_t> seg;
    while (!can_decode_ && marker != kEOC) {
      while (marker != kSOD) {
        if (s_.left() == 0) {
          state_ = kNeoc;
          break;
        }
        uint32_t size;
        if (!s_.read16(size)) fail();
        if (size < 2) fail();  // "Inconsistent marker size"
        if (marker == 0x8080 && s_.left() == 0) {
          state_ = kNeoc;
          break;
        }
        if ((state_ & kTph) && sot_length_ != 0) {
          if (sot_length_ < size + 2) fail();
          sot_length_ -= size + 2;
        }
        size -= 2;
        bool known;
        const int states = marker_states(marker, known);
        if (!(state_ & states)) fail();  // "Marker is not compliant with its position"
        seg.resize(size + 1);
        if (!s_.read(seg.data(), size)) fail();
        if (!known) fail();  // "Not sure how that happened."
        if (marker == kSOT)
          read_sot(seg.data(), size);
        else
          read_segment(cs, cs.tcps[current_], marker, seg.data(), size);
        if (!s_.read16(marker)) fail();
      }
      if (s_.left() == 0 && state_ == kNeoc) break;
      read_sod();
      if (can_decode_ && !correction_checked_) {
        correction_checked_ = true;
        // skipped where the tile declares a single tile-part, and on a
        // stream without seek (Pillow's)
        if (seekable_ && cs.tcps[current_].nb_parts != 1 &&
            correction_needed()) {
          for (Tcp& t : cs.tcps)
            if (t.nb_parts) t.nb_parts += 1;
          nb_parts_correction_ = 1;
          can_decode_ = false;
        }
      }
      if (!can_decode_ && !s_.read16(marker)) {
        // the last tile's tile-part with TPsot 0 and TNsot 0 and no EOC
        // (non-conformant SPOT6 files): the first such tile is decoded
        const int ntiles = cs.tw * cs.th;
        if (current_ + 1 == ntiles) {
          int t = 0;
          while (t < ntiles && !(cs.tcps[t].current_part == 0 &&
                                 cs.tcps[t].nb_parts == 0))
            ++t;
          if (t < ntiles) {
            current_ = t;
            marker = kEOC;
            state_ = kEoc;
            break;
          }
        }
        fail();  // "Stream too short"
      }
    }
    if (marker == kEOC && state_ != kEoc) {
      current_ = 0;
      state_ = kEoc;
    }
    if (!can_decode_) {
      const int ntiles = cs.tw * cs.th;
      while (current_ < ntiles && !cs.tcps[current_].has_data) ++current_;
      if (current_ == ntiles) return false;
    }
    tileno = current_;
    state_ |= kData;
    return true;
  }

  void read_sot(const uint8_t* p, uint32_t size) {
    if (size != 8) fail();
    const uint32_t tile = be16(p), psot = be32(p + 2);
    const uint32_t part = p[6];
    uint32_t parts = p[7];
    if (tile >= static_cast<uint32_t>(cs.tw * cs.th)) fail();
    current_ = static_cast<int>(tile);
    Tcp& tcp = cs.tcps[tile];
    if (tcp.current_part + 1 != static_cast<int>(part)) fail();
    tcp.current_part = static_cast<int>(part);
    if (psot != 0 && psot < 14 && psot != 12) fail();
    if (psot == 0) last_tile_part_ = true;
    if (tcp.nb_parts != 0 && part >= static_cast<uint32_t>(tcp.nb_parts)) fail();
    if (parts != 0) {
      parts += nb_parts_correction_;
      if (part >= parts) fail();
      tcp.nb_parts = static_cast<int>(parts);
    }
    if (tcp.nb_parts && tcp.nb_parts == static_cast<int>(part) + 1) can_decode_ = true;
    sot_length_ = last_tile_part_ ? 0 : psot - 12;
    state_ = kTph;
  }

  void read_sod() {
    Tcp& tcp = cs.tcps[current_];
    if (last_tile_part_) {
      const int64_t l = static_cast<int64_t>(s_.left()) - 2;
      sot_length_ = static_cast<uint32_t>(l);
    } else if (sot_length_ >= 2) {
      sot_length_ -= 2;
    }
    size_t got = 0;
    if (sot_length_) {
      if (sot_length_ > s_.left()) fail();  // "Tile part length size inconsistent"
      tcp.data.insert(tcp.data.end(), s_.d + s_.pos, s_.d + s_.pos + sot_length_);
      s_.pos += sot_length_;
      got = sot_length_;
      tcp.has_data = true;
    }
    state_ = got != sot_length_ ? kNeoc : kTphSot;
  }

  // opj_j2k_need_nb_tile_parts_correction: a later tile-part of the tile
  // just completed whose TPsot equals its TNsot.
  bool correction_needed() {
    size_t pos = s_.pos;
    for (;;) {
      if (s_.n - pos < 2) return false;
      if (be16(s_.d + pos) != kSOT) return false;
      pos += 2;
      if (s_.n - pos < 2) fail();  // "Stream too short"
      if (be16(s_.d + pos) != 10) fail();  // "Inconsistent marker size"
      pos += 2;
      if (s_.n - pos < 8) fail();
      const uint8_t* p = s_.d + pos;
      pos += 8;
      const uint32_t tile = be16(p), psot = be32(p + 2), part = p[6],
                     parts = p[7];
      if (static_cast<int>(tile) == current_) return part == parts;
      if (psot < 14) return false;
      if (s_.n - pos < psot - 12) return false;
      pos += psot - 12;
    }
  }

  Jp2Boxes boxes_{jp2};
  Stream s_{nullptr, 0};
  int state_ = 0, current_ = 0, nb_parts_correction_ = 0;
  bool can_decode_ = false, last_tile_part_ = false, correction_checked_ = false;
  bool seekable_ = true;
  uint32_t sot_length_ = 0;
};

bool is_j2k(const uint8_t* d, size_t n) {
  return (n >= 12 && !std::memcmp(d, "\0\0\0\x0cjP  \r\n\x87\n", 12)) ||
         (n >= 4 && !std::memcmp(d, "\xff\x4f\xff\x51", 4));
}

// ---------------------------------------------------------- the readers

// The components opj_decode gives, each (x1 - x0) x (y1 - y0) on the grid
// (opj_j2k_update_image_data; a tile never decoded stays 0).
struct Planes {
  int x0, y0, w, h;
  std::vector<std::vector<int32_t>> comps;
};

// opj_jp2_check_color over an image of `numcomps` components: false where
// OpenJPEG refuses the cdef and cmap boxes. A cmap of a one-component image
// that leaves a palette column unused is rewritten to map every column
// ("Component mapping seems wrong. Trying to correct.").
bool check_color(Jp2Info& jp2, size_t numcomps) {
  Palette& pl = jp2.pclr;
  const bool mapped = jp2.has_pclr && pl.has_cmap;
  if (jp2.has_cdef) {
    // cdef names the channels after the palette where a cmap is given
    const size_t nch = mapped ? static_cast<size_t>(pl.npc) : numcomps;
    for (const ChannelDef& c : jp2.cdef) {
      if (c.cn >= nch) return false;  // "Invalid component index"
      if (c.asoc == 65535) continue;
      if (c.asoc > 0 && c.asoc - 1 >= nch) return false;
    }
    for (size_t k = nch; k > 0; k--) {  // "Incomplete channel definitions"
      bool found = false;
      for (const ChannelDef& c : jp2.cdef) found |= c.cn == k - 1;
      if (!found) return false;
    }
  }
  if (mapped) {
    const int nch = pl.npc;
    bool sane = true;
    for (const Palette::Map& m : pl.cmap)
      if (m.cmp >= numcomps) sane = false;  // "Invalid component index"
    std::vector<char> used(nch, 0);
    for (int i = 0; i < nch; i++) {
      const Palette::Map& m = pl.cmap[i];
      if ((m.mtyp != 0 && m.mtyp != 1) ||   // "Invalid value for cmap[%d].mtyp"
          m.pcol >= nch ||                  // "Invalid component/palette index"
          (used[m.pcol] && m.mtyp == 1) ||  // "Component %d is mapped twice"
          (m.mtyp == 0 && m.pcol != 0) ||   // "Direct use at #%d however pcol=%d"
          (m.mtyp == 1 && m.pcol != i))     // "Implementation limitation"
        sane = false;
      else
        used[m.pcol] = 1;
    }
    for (int i = 0; i < nch; i++)
      if (!used[i] && pl.cmap[i].mtyp != 0) sane = false;  // "doesn't have a mapping"
    if (sane && numcomps == 1 &&
        std::find(used.begin(), used.end(), 0) != used.end())
      for (int i = 0; i < nch; i++) pl.cmap[i] = {pl.cmap[i].cmp, 1, static_cast<uint8_t>(i)};
    if (!sane) return false;
  }
  return true;
}

// What opj_jp2_decode does to the decoded components: opj_jp2_check_color
// (Fail where it refuses), a pclr box without its cmap dropped, else
// opj_jp2_apply_pclr (an index clamped to the palette, MTYP 0 components
// passed through), then opj_jp2_apply_cdef's swaps, in its order.
void jp2_colour(Jp2Info& jp2, Planes& pl) {
  if (!check_color(jp2, pl.comps.size())) fail();
  if (jp2.has_pclr && jp2.pclr.has_cmap) {
    const Palette& p = jp2.pclr;
    const int top = p.ne - 1;
    std::vector<std::vector<int32_t>> out(p.npc);
    for (int i = 0; i < p.npc; i++) {
      const std::vector<int32_t>& src = pl.comps[p.cmap[i].cmp];
      if (p.cmap[i].mtyp == 0) {
        out[i] = src;
        continue;
      }
      out[i].resize(src.size());
      for (size_t k = 0; k < src.size(); k++) {
        const int idx = std::clamp(src[k], 0, top);
        out[i][k] = static_cast<int32_t>(p.entries[static_cast<size_t>(idx) * p.npc + i]);
      }
    }
    pl.comps.swap(out);
  }
  if (jp2.has_cdef) {
    std::vector<ChannelDef> info = jp2.cdef;
    const size_t nc = pl.comps.size();
    for (size_t i = 0; i < info.size(); i++) {
      const uint32_t cn = info[i].cn, asoc = info[i].asoc;
      if (cn >= nc) continue;                      // "opj_jp2_apply_cdef: cn=%d"
      if (asoc == 0 || asoc == 65535) continue;   // the alpha flag only
      const uint32_t acn = asoc - 1;
      if (acn >= nc) continue;                     // "opj_jp2_apply_cdef: acn=%d"
      if (cn != acn && info[i].typ == 0) {  // only a colour channel moves
        pl.comps[cn].swap(pl.comps[acn]);
        for (size_t k = i + 1; k < info.size(); k++) {
          if (info[k].cn == cn)
            info[k].cn = acn;
          else if (info[k].cn == acn)
            info[k].cn = cn;
        }
      }
    }
  }
}

void decode_planes(J2k& j, Planes& out) {
  out.x0 = j.cs.x0;
  out.y0 = j.cs.y0;
  out.w = j.cs.x1 - j.cs.x0;
  out.h = j.cs.y1 - j.cs.y0;
  out.comps.assign(j.cs.comps.size(), std::vector<int32_t>());
  j.decode(false, [&](const std::vector<TileComp>& tile) {
    for (size_t c = 0; c < tile.size(); c++) {
      std::vector<int32_t>& dst = out.comps[c];
      if (dst.empty()) dst.assign(static_cast<size_t>(out.w) * out.h, 0);
      // opj_j2k_update_image_data: the decoded resolution's samples at its
      // own coordinates on the grid, cut to the image
      const TileComp& tc = tile[c];
      const Res& r = tc.out();
      for (int y = 0; y < tc.out_h(); y++) {
        const int64_t dy = int64_t{r.y0} + y - out.y0;
        if (dy < 0 || dy >= out.h) continue;
        for (int x = 0; x < tc.out_w(); x++) {
          const int64_t dx = int64_t{r.x0} + x - out.x0;
          if (dx < 0 || dx >= out.w) continue;
          dst[static_cast<size_t>(dy) * out.w + static_cast<size_t>(dx)] =
              tc.idata[static_cast<size_t>(y) * tc.w() + x];
        }
      }
    }
  });
  for (auto& c : out.comps)
    if (c.empty()) fail();  // "Failed to decode all used components"
  if (j.jp2.jp2) jp2_colour(j.jp2, out);
}

// OpenCV's COLOR_YUV2BGR on 8-bit samples (YCrCb2RGB_i with its YUV
// coefficients, 14-bit fixed point), as RGB.
void cv2_yuv_rgb(int y, int u, int v, uint8_t* o) {
  auto descale = [](int x) { return (x + (1 << 13)) >> 14; };
  const int b = y + descale((u - 128) * 33292);
  const int g = y + descale((u - 128) * -6472 + (v - 128) * -9519);
  const int r = y + descale((v - 128) * 18678);
  o[0] = static_cast<uint8_t>(std::clamp(r, 0, 255));
  o[1] = static_cast<uint8_t>(std::clamp(g, 0, 255));
  o[2] = static_cast<uint8_t>(std::clamp(b, 0, 255));
}

// OpenCV 5's Jpeg2KOpjDecoder under cv2.imread's IMREAD_COLOR: readHeader
// on the codestream's components (1-4 of them, none signed, a precision of
// 8 or more), imread's size rule, then readData: opj_decode (the JP2 colour
// boxes applied: pclr and cmap, cdef), the colour space (sRGB, and unknown
// and unspecified taken for sRGB: comps 2, 1, 0 of 3 or more; gray: comp 0
// three times, also after a palette made 3; sYCC: comps 0-2 of 3 or more
// through COLOR_YUV2BGR; CMYK, eYCC: refused), no image offset, each
// sample >> (the header's max precision - 8) cast to 8 bits.
int read_cv2_j2k(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  J2k j;
  try {
    j.read_header(d, n);
  } catch (const Fail&) {
    return kUnreadable;
  }
  const size_t ncomp = j.cs.comps.size();
  if (ncomp > 4) return kUnreadable;  // "Unsupported number of components"
  int maxprec = 0;
  for (const CompInfo& c : j.cs.comps) {
    if (c.sgnd) return kUnreadable;
    maxprec = std::max(maxprec, c.prec);
  }
  if (maxprec < 8) return kUnreadable;
  const int64_t w = int64_t{j.cs.x1} - j.cs.x0, h = int64_t{j.cs.y1} - j.cs.y0;
  if (!cv2_size_ok(w, h)) return kRaises;
  // readData: what opj_decode's colour boxes leave (check_color refuses
  // from the header alone), then the colour space
  if (j.jp2.jp2 && !check_color(j.jp2, ncomp)) return kUnreadable;
  const Palette& pal = j.jp2.pclr;
  const size_t nc = j.jp2.has_pclr && pal.has_cmap ? static_cast<size_t>(pal.npc) : ncomp;
  const int cs = j.color_space;
  if (cs == kCsCmyk || cs == kCsEycc) return kUnreadable;  // "Unsupported color space"
  if (cs != kCsGray && nc < 3) return kUnreadable;  // "unsupported conversion"
  if (j.cs.x0 != 0 || j.cs.y0 != 0) return kUnreadable;  // "tiles are not supported"
  dims[0] = static_cast<int>(h);
  dims[1] = static_cast<int>(w);
  if (head) return kOk;
  Planes pl;
  try {
    decode_planes(j, pl);
  } catch (const Fail&) {
    return kUnreadable;
  }
  if (!img) return kOk;
  const int shift = maxprec > 8 ? maxprec - 8 : 0;
  img->w = pl.w;
  img->h = pl.h;
  img->rgb.resize(static_cast<size_t>(pl.w) * pl.h * 3);
  const size_t area = static_cast<size_t>(pl.w) * pl.h;
  const bool gray = cs == kCsGray;
  for (int c = 0; c < 3; c++) {
    const std::vector<int32_t>& src = pl.comps[gray ? 0 : c];
    uint8_t* out = img->rgb.data() + c;
    for (size_t i = 0; i < area; i++) out[3 * i] = static_cast<uint8_t>(src[i] >> shift);
  }
  if (cs == kCsSycc)
    for (size_t i = 0; i < area; i++) {
      uint8_t* px = &img->rgb[3 * i];
      cv2_yuv_rgb(px[0], px[1], px[2], px);
    }
  return kOk;
}

// Pillow's Jpeg2KImagePlugin._open: the size and mode (L, I;16, LA, RGB,
// RGBA, CMYK, and P or PA with the palette it makes of a pclr box) from the
// SIZ marker or the JP2 header boxes, then _parse_comment's walk of the
// main header's markers.
struct PilHeader {
  int w = 0, h = 0;
  enum Mode { kNone, kL, kI16, kLA, kRGB, kRGBA, kCmyk, kP, kPA } mode = kNone;
  // P and PA: the image palette's RGB by index after Image.load's
  // putpalette (black past the colours the pclr box gave)
  uint8_t palette[256][3] = {};
};

struct PilFile {
  const uint8_t* d;
  size_t n, pos = 0;
  std::vector<uint8_t> read(size_t k) {  // fp.read(k): short at the end
    const size_t got = std::min(k, pos < n ? n - pos : 0);
    std::vector<uint8_t> out(d + std::min(pos, n), d + std::min(pos, n) + got);
    pos += got;
    return out;
  }
  std::vector<uint8_t> exact(size_t k) {
    std::vector<uint8_t> v = read(k);
    if (v.size() < k) fail();
    return v;
  }
};

void pil_parse_comment(PilFile& f) {
  for (;;) {
    const std::vector<uint8_t> m = f.read(2);
    if (m.empty()) break;
    if (m.size() < 2) fail();  // marker[1]: IndexError
    if (m[1] == 0x90 || m[1] == 0xd9) break;
    const std::vector<uint8_t> h = f.exact(2);
    const int64_t length = be16(h.data());
    if (m[1] == 0x64) break;
    const int64_t to = static_cast<int64_t>(f.pos) + length - 2;
    if (to < 0) fail();
    f.pos = static_cast<size_t>(to);
  }
}

// BoxReader over bytes [start, start + length) (length < 0: the file).
struct PilBoxes {
  PilFile& f;
  size_t start;
  int64_t length;
  int64_t remaining = -1;
  int64_t tell() const { return static_cast<int64_t>(f.pos - start); }
  bool can_read(int64_t k) const {
    if (length >= 0 && tell() + k > length) return false;
    if (remaining >= 0) return k <= remaining;
    return true;
  }
  std::vector<uint8_t> bytes(int64_t k) {
    if (!can_read(k)) fail();  // "Not enough data in header"
    std::vector<uint8_t> v = f.read(static_cast<size_t>(k));
    if (static_cast<int64_t>(v.size()) < k) fail();
    if (remaining > 0) remaining -= k;
    return v;
  }
  bool has_next() const { return length < 0 || tell() + remaining < length; }
  uint32_t next() {
    if (remaining > 0) f.pos += static_cast<size_t>(remaining);
    remaining = -1;
    const std::vector<uint8_t> h = bytes(8);
    uint64_t lbox = be32(h.data());
    int hlen = 8;
    if (lbox == 1) {
      const std::vector<uint8_t> x = bytes(8);
      lbox = uint64_t{be32(x.data())} << 32 | be32(x.data() + 4);
      hlen = 16;
    }
    if (lbox < static_cast<uint64_t>(hlen) || lbox > (uint64_t{1} << 62) ||
        !can_read(static_cast<int64_t>(lbox) - hlen))
      fail();  // "Invalid header length"
    remaining = static_cast<int64_t>(lbox) - hlen;
    return be32(h.data() + 4);
  }
};

// _parse_jp2_header's pclr palette: ImagePalette.getcolor of each entry
// (one byte a column, whatever its Bi; a colour seen before keeps its
// index, a new one is written at len(palette) // len(mode), over the bytes
// there if any), then putpalette's unpack of whole RGB or RGBA entries.
void pil_palette(PilBoxes& hb, int ne, int npc, PilHeader& out) {
  const size_t mlen = npc == 4 ? 4 : 3;
  std::vector<uint8_t> pal;
  std::map<std::vector<uint8_t>, int> colors;
  for (int i = 0; i < ne; i++) {
    const std::vector<uint8_t> c = hb.bytes(npc);
    if (colors.count(c)) continue;
    const size_t index = pal.size() / mlen;
    if (index >= 256) fail();  // "cannot allocate more than 256 colors"
    colors[c] = static_cast<int>(index);
    if (index * mlen < pal.size()) {
      std::vector<uint8_t> next(pal.begin(), pal.begin() + index * mlen);
      next.insert(next.end(), c.begin(), c.end());
      if (index * mlen + mlen < pal.size())
        next.insert(next.end(), pal.begin() + index * mlen + mlen, pal.end());
      pal.swap(next);
    } else {
      pal.insert(pal.end(), c.begin(), c.end());
    }
  }
  for (size_t k = 0; k < pal.size() / mlen; k++)
    std::memcpy(out.palette[k], &pal[k * mlen], 3);
}

void pil_open(const uint8_t* d, size_t n, PilHeader& out) {
  PilFile f{d, n};
  const std::vector<uint8_t> sig = f.read(4);
  if (sig.size() == 4 && !std::memcmp(sig.data(), "\xff\x4f\xff\x51", 4)) {
    const std::vector<uint8_t> hdr = f.read(2);
    if (hdr.size() < 2) fail();
    const uint32_t lsiz = be16(hdr.data());
    std::vector<uint8_t> siz = hdr;
    const int64_t more = int64_t{lsiz} - 2;
    if (more > 0) {
      const std::vector<uint8_t> rest = f.read(static_cast<size_t>(more));
      siz.insert(siz.end(), rest.begin(), rest.end());
    } else if (more < 0) {
      fail();  // fp.read(-k) reads the rest, then the unpack fails first
    }
    if (siz.size() < 38) fail();
    const int64_t xsiz = be32(&siz[4]), ysiz = be32(&siz[8]),
                  xo = be32(&siz[12]), yo = be32(&siz[16]);
    const uint32_t csiz = be16(&siz[36]);
    out.w = static_cast<int>(std::clamp<int64_t>(xsiz - xo, -1, 1 << 30));
    out.h = static_cast<int>(std::clamp<int64_t>(ysiz - yo, -1, 1 << 30));
    if (csiz == 1) {
      if (siz.size() < 39) fail();
      out.mode = (siz[38] & 0x7f) + 1 > 8 ? PilHeader::kI16 : PilHeader::kL;
    } else if (csiz == 2) {
      out.mode = PilHeader::kLA;
    } else if (csiz == 3) {
      out.mode = PilHeader::kRGB;
    } else if (csiz == 4) {
      out.mode = PilHeader::kRGBA;
    } else {
      fail();
    }
    pil_parse_comment(f);
  } else {
    const std::vector<uint8_t> rest = f.read(8);
    std::vector<uint8_t> s12 = sig;
    s12.insert(s12.end(), rest.begin(), rest.end());
    if (s12.size() != 12 || std::memcmp(s12.data(), "\0\0\0\x0cjP  \r\n\x87\n", 12))
      fail();
    PilBoxes top{f, 0, -1};
    std::vector<uint8_t> header;
    for (;;) {
      const uint32_t t = top.next();
      if (t == 0x6a703268) {  // jp2h
        header = top.bytes(top.remaining);
        break;
      }
      if (t == 0x66747970) top.bytes(4);  // ftyp's brand
    }
    PilFile hf{header.data(), header.size()};
    PilBoxes hb{hf, 0, static_cast<int64_t>(header.size())};
    bool has_size = false;
    int nc = 0;
    while (hb.has_next()) {
      const uint32_t t = hb.next();
      if (t == 0x69686472) {  // ihdr
        const std::vector<uint8_t> v = hb.bytes(11);
        out.h = static_cast<int>(std::min<uint32_t>(be32(&v[0]), 1u << 30));
        out.w = static_cast<int>(std::min<uint32_t>(be32(&v[4]), 1u << 30));
        nc = static_cast<int>(be16(&v[8]));
        const int bpc = v[10];
        has_size = true;
        if (nc == 1 && (bpc & 0x7f) > 8)
          out.mode = PilHeader::kI16;
        else if (nc == 1)
          out.mode = PilHeader::kL;
        else if (nc == 2)
          out.mode = PilHeader::kLA;
        else if (nc == 3)
          out.mode = PilHeader::kRGB;
        else if (nc == 4)
          out.mode = PilHeader::kRGBA;
      } else if (t == 0x636f6c72 && nc == 4) {  // colr: every one counts
        const std::vector<uint8_t> v = hb.bytes(7);
        if (v[0] == 1 && be32(&v[3]) == 12) out.mode = PilHeader::kCmyk;
      } else if (t == 0x70636c72 &&
                 (out.mode == PilHeader::kL || out.mode == PilHeader::kLA)) {
        const std::vector<uint8_t> v = hb.bytes(3);
        const int ne = static_cast<int>(be16(v.data())), npc = v[2];
        int maxbits = 0;  // Bi as stored, the sign bit with it
        for (uint8_t b : hb.bytes(npc)) maxbits = std::max<int>(maxbits, b);
        if (maxbits <= 8) {
          pil_palette(hb, ne, npc, out);
          out.mode = out.mode == PilHeader::kL ? PilHeader::kP : PilHeader::kPA;
        }
      } else if (t == 0x72657320) {  // res
        const std::vector<uint8_t> r = hb.bytes(hb.remaining);
        PilFile rf{r.data(), r.size()};
        PilBoxes rb{rf, 0, static_cast<int64_t>(r.size())};
        while (rb.has_next()) {
          if (rb.next() == 0x72657363) {  // resc
            rb.bytes(10);
            break;
          }
        }
      }
    }
    if (!has_size || out.mode == PilHeader::kNone) fail();  // "Malformed JP2 header"
    const std::vector<uint8_t> next = f.read(12);
    if (next.size() >= 8 &&
        !std::memcmp(next.data() + next.size() - 8, "jp2c\xff\x4f\xff\x51", 8)) {
      const std::vector<uint8_t> hdr = f.exact(2);
      const int64_t to = static_cast<int64_t>(f.pos) + int64_t{be16(hdr.data())} - 2;
      if (to < 0) fail();
      f.pos = static_cast<size_t>(to);
      pil_parse_comment(f);
    }
  }
  if (out.w <= 0 || out.h <= 0) fail();  // "not identified by this driver"
  if (!pil_size_ok(out.w, out.h)) fail();
}

// Pillow's ImagingConvertYCbCr2RGB (ConvertYCbCr.c: tables of
// int(c * 64 * (i - 128) + 0.5), then >> 6), which j2ku_sycc_rgb runs.
void pil_ycbcr_rgb(int y, int cb, int cr, uint8_t* o) {
  struct Tables {
    int r_cr[256], g_cb[256], g_cr[256], b_cb[256];
    Tables() {
      for (int i = 0; i < 256; i++) {
        r_cr[i] = static_cast<int>(1.402 * 64 * (i - 128) + 0.5);
        g_cb[i] = static_cast<int>(-0.34414 * 64 * (i - 128) + 0.5);
        g_cr[i] = static_cast<int>(-0.71414 * 64 * (i - 128) + 0.5);
        b_cb[i] = static_cast<int>(1.772 * 64 * (i - 128) + 0.5);
      }
    }
  };
  static const Tables t;
  const int r = y + (t.r_cr[cr] >> 6);
  const int g = y + ((t.g_cb[cb] + t.g_cr[cr]) >> 6);
  const int b = y + (t.b_cb[cb] >> 6);
  o[0] = static_cast<uint8_t>(std::clamp(r, 0, 255));
  o[1] = static_cast<uint8_t>(std::clamp(g, 0, 255));
  o[2] = static_cast<uint8_t>(std::clamp(b, 0, 255));
}

// Jpeg2KDecode.c's j2ku_shift on an unsigned sample word.
uint32_t pil_shift(uint32_t x, int n) { return n < 0 ? x >> -n : x << n; }

// Pillow's decoder (Jpeg2KDecode.c: the checks, the unpacker its table
// picks, tile by tile) and convert("RGB").
int read_pil_j2k(const uint8_t* d, size_t n, Image* img, int* dims, bool head) {
  PilHeader ph;
  J2k j;
  try {
    pil_open(d, n, ph);
    dims[0] = ph.h;
    dims[1] = ph.w;
    if (head) return kOk;
    j.read_header(d, n);
  } catch (const Fail&) {
    return kUnreadable;
  }
  const int nc = static_cast<int>(j.cs.comps.size());
  int cs = j.color_space;
  if (cs == kCsUnspecified || cs == kCsUnknown) cs = nc <= 2 ? kCsGray : kCsSrgb;
  // the unpacker table: (mode, colour space, components); P and PA unpack
  // their indices as L and LA do, CMYK its four components as RGBA does
  enum Unpack { kNoUnpack, kGrayL, kGrayI, kGrayALA, kGrayRGB, kSrgbRGB,
                kSyccRGB, kCmykRGB };
  Unpack u = kNoUnpack;
  using M = PilHeader;
  const bool rgb3 = nc == 3 || nc == 4;
  if (ph.mode == M::kL && cs == kCsGray && nc == 1) u = kGrayL;
  if (ph.mode == M::kP && cs == kCsSrgb && nc == 1) u = kGrayL;
  if (ph.mode == M::kPA && cs == kCsSrgb && nc == 2) u = kGrayALA;
  if (ph.mode == M::kI16 && cs == kCsGray && nc == 1) u = kGrayI;
  if (ph.mode == M::kLA && cs == kCsGray && nc == 2) u = kGrayALA;
  if (ph.mode == M::kRGB && cs == kCsGray && (nc == 1 || nc == 2)) u = kGrayRGB;
  if (ph.mode == M::kRGB && cs == kCsSrgb && rgb3) u = kSrgbRGB;
  if (ph.mode == M::kRGB && cs == kCsSycc && rgb3) u = kSyccRGB;
  if (ph.mode == M::kRGBA && cs == kCsGray && nc == 1) u = kGrayRGB;
  if (ph.mode == M::kRGBA && cs == kCsGray && nc == 2) u = kGrayALA;
  if (ph.mode == M::kRGBA && cs == kCsSrgb && rgb3) u = kSrgbRGB;
  if (ph.mode == M::kRGBA && cs == kCsGray && nc == 4) u = kSrgbRGB;
  if (ph.mode == M::kRGBA && cs == kCsSycc && rgb3) u = kSyccRGB;
  if (ph.mode == M::kCmyk && cs == kCsCmyk && nc == 4) u = kCmykRGB;
  if (u == kNoUnpack) return kUnreadable;
  const bool paletted = ph.mode == M::kP || ph.mode == M::kPA;
  // what convert("RGB") makes of the image's zeros where no tile writes
  uint8_t blank[3] = {0, 0, 0};
  if (paletted) std::memcpy(blank, ph.palette[0], 3);
  if (u == kCmykRGB) cmyk_to_rgb(0, 0, 0, 0, blank);
  std::vector<uint8_t> rgb(static_cast<size_t>(ph.w) * ph.h * 3);
  for (size_t i = 0; i < rgb.size(); i++) rgb[i] = blank[i % 3];
  const int ncomp = u == kCmykRGB ? 4 : u == kSrgbRGB || u == kSyccRGB ? 3 : 1;
  // kGrayRGB's image as Pillow holds it, 4 bytes a pixel
  std::vector<uint8_t> im4(u == kGrayRGB ? rgb.size() / 3 * 4 : 0, 0);
  // Jpeg2KDecode.c's tile buffer, zeros for each tile:
  // opj_tcd_update_tile_data packs each component's decoded samples into
  // it, the unpacker reads it as whole-tile planes
  std::vector<uint8_t> tbuf;
  try {
    j.decode(true, [&](const std::vector<TileComp>& tile) {
      const TileComp& t0 = tile[0];
      if (t0.x0 < j.cs.x0 || t0.y0 < j.cs.y0 ||
          int64_t{t0.x1} - j.cs.x0 > ph.w || int64_t{t0.y1} - j.cs.y0 > ph.h)
        fail();  // the tile lies outside the image
      const size_t tw = static_cast<size_t>(t0.w()), th = static_cast<size_t>(t0.h());
      std::vector<size_t> csiz(tile.size()), plane(tile.size());
      size_t need = 0;
      for (size_t c = 0; c < tile.size(); c++) {
        csiz[c] = static_cast<size_t>((j.cs.comps[c].prec + 7) >> 3);
        if (csiz[c] == 3) csiz[c] = 4;
        plane[c] = need;
        need += csiz[c] * tw * th;
      }
      tbuf.assign(need, 0);
      size_t at = 0;
      for (size_t c = 0; c < tile.size(); c++) {
        const TileComp& tc = tile[c];
        for (int y = 0; y < tc.out_h(); y++)
          for (int x = 0; x < tc.out_w(); x++) {
            const uint32_t v = static_cast<uint32_t>(tc.idata[static_cast<size_t>(y) * tc.w() + x]);
            for (size_t k = 0; k < csiz[c]; k++) tbuf[at++] = static_cast<uint8_t>(v >> (8 * k));
          }
      }
      int shift[4];
      uint32_t offset[4];
      for (int c = 0; c < ncomp; c++) {
        const CompInfo& ci = j.cs.comps[c];
        shift[c] = (u == kGrayI ? 16 : 8) - ci.prec;
        offset[c] = ci.sgnd ? 1u << (ci.prec - 1) : 0;
        if (shift[c] < 0) offset[c] += 1u << (-shift[c] - 1);
      }
      for (size_t y = 0; y < th; y++)
        for (size_t x = 0; x < tw; x++) {
          uint8_t b[4];
          for (int c = 0; c < ncomp; c++) {
            const size_t bytes = csiz[c];
            const uint8_t* q = &tbuf[plane[c] + (y * tw + x) * bytes];
            uint32_t word = 0;
            for (size_t k = 0; k < bytes; k++) word |= uint32_t{q[k]} << (8 * k);
            const uint32_t v = pil_shift(offset[c] + word, shift[c]);
            if (u == kGrayI) {
              const uint16_t v16 = static_cast<uint16_t>(v);
              b[c] = v16 > 255 ? 255 : static_cast<uint8_t>(v16);  // I;16 -> RGB
            } else {
              b[c] = static_cast<uint8_t>(v);
            }
          }
          const size_t row = t0.y0 - j.cs.y0 + y, x0 = t0.x0 - j.cs.x0;
          if (u == kGrayRGB) {
            // j2ku_gray_rgb steps its 4-byte pixels from byte x0 of the
            // row, not from pixel x0: (v, v, v, 255) at x0 + 4x
            uint8_t* q = &im4[row * ph.w * 4 + x0 + 4 * x];
            q[0] = q[1] = q[2] = b[0];
            q[3] = 255;
            continue;
          }
          uint8_t* px = &rgb[(row * static_cast<size_t>(ph.w) + x0 + x) * 3];
          if (paletted)
            std::memcpy(px, ph.palette[b[0]], 3);
          else if (ncomp == 1)
            px[0] = px[1] = px[2] = b[0];
          else if (u == kSyccRGB)
            pil_ycbcr_rgb(b[0], b[1], b[2], px);
          else if (u == kCmykRGB)
            cmyk_to_rgb(b[0], b[1], b[2], b[3], px);
          else
            std::memcpy(px, b, 3);
        }
    });
    if (j.jp2.jp2) j.end_jp2(d, n);
  } catch (const Fail&) {
    return kUnreadable;
  }
  for (size_t i = 0; i < im4.size() / 4; i++) std::memcpy(&rgb[3 * i], &im4[4 * i], 3);
  if (img) {
    img->w = ph.w;
    img->h = ph.h;
    img->rgb.swap(rgb);
  }
  return kOk;
}

}  // namespace

bool jpeg2000_planes(const uint8_t* data, size_t n, int32_t* out, size_t cap,
                     int* info) {
  try {
    J2k j;
    j.read_header(data, n);
    Planes pl;
    decode_planes(j, pl);
    const size_t area = static_cast<size_t>(pl.w) * pl.h;
    if (area * pl.comps.size() > cap) return false;
    for (size_t c = 0; c < pl.comps.size(); c++)
      std::copy(pl.comps[c].begin(), pl.comps[c].end(), out + c * area);
    info[0] = static_cast<int>(pl.comps.size());
    info[1] = pl.h;
    info[2] = pl.w;
    info[3] = pl.x0;
    info[4] = pl.y0;
    return true;
  } catch (const Fail&) {
    return false;
  } catch (const Unsupported&) {
    return false;
  }
}

bool is_jpeg2000_data(const uint8_t* data, size_t n) { return is_j2k(data, n); }

int jpeg2000_cv2(const uint8_t* data, size_t n, Image* img, int* dims, bool head) {
  try {
    return read_cv2_j2k(data, n, img, dims, head);
  } catch (const Unsupported&) {
    return kJpeg2000;
  } catch (const Fail&) {
    return kUnreadable;
  }
}

int jpeg2000_pil(const uint8_t* data, size_t n, Image* img, int* dims, bool head) {
  try {
    return read_pil_j2k(data, n, img, dims, head);
  } catch (const Unsupported&) {
    return kJpeg2000;
  } catch (const Fail&) {
    return kUnreadable;
  }
}

}  // namespace tsrio
