// A JPEG writer over the system libjpeg (libjpeg-turbo), for the forms that
// neither OpenCV nor Pillow writes: arithmetic-coded files (sequential, SOF9,
// and progressive, SOF10) with chosen DAC conditioning.  The tests of
// ``tests/test_torch_imageio_damaged.py`` compile it with
// ``g++ -O1 torch_jpeg_writer.cpp -ljpeg`` and run it:
//
//   torch_jpeg_writer in.raw H W C quality progressive restart sampling L U K out.jpg
//
// ``in.raw`` holds H x W x C uint8 samples (C = 1: gray, 3: RGB); sampling
// is the luma's factors ("11", "21", "22"), the chroma's are 1x1; L, U (DC)
// and K (AC) are the arithmetic conditioning of every table.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include <jpeglib.h>

int main(int argc, char** argv) {
  if (argc != 13) {
    std::fprintf(stderr, "usage: %s in.raw H W C quality progressive restart hv L U K out\n",
                 argv[0]);
    return 2;
  }
  const int h = std::atoi(argv[2]), w = std::atoi(argv[3]), c = std::atoi(argv[4]);
  std::vector<unsigned char> px(static_cast<size_t>(h) * w * c);
  FILE* in = std::fopen(argv[1], "rb");
  if (!in || std::fread(px.data(), 1, px.size(), in) != px.size()) return 3;
  std::fclose(in);
  FILE* out = std::fopen(argv[12], "wb");
  if (!out) return 3;
  jpeg_compress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, std::atoi(argv[5]), TRUE);
  cinfo.arith_code = TRUE;
  cinfo.restart_interval = static_cast<unsigned>(std::atoi(argv[7]));
  cinfo.comp_info[0].h_samp_factor = argv[8][0] - '0';
  cinfo.comp_info[0].v_samp_factor = argv[8][1] - '0';
  for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
    cinfo.arith_dc_L[t] = static_cast<UINT8>(std::atoi(argv[9]));
    cinfo.arith_dc_U[t] = static_cast<UINT8>(std::atoi(argv[10]));
    cinfo.arith_ac_K[t] = static_cast<UINT8>(std::atoi(argv[11]));
  }
  if (std::atoi(argv[6])) jpeg_simple_progression(&cinfo);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = px.data() + static_cast<size_t>(cinfo.next_scanline) * w * c;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  std::fclose(out);
  return 0;
}
