"""LibriSpeech subset download, extraction and manifest.

    python -m wav2letter_pytorch_tpu_torch.data.prepare_librispeech \
        --subset dev-clean --manifest_path dev_clean.csv

The same command line and functions as the JAX package's
``data/prepare_librispeech.py``: fetch ``<subset>.tar.gz`` from openslr.org
unless it is already in ``--download_dir``, unpack it, walk its
``*/*/*.trans.txt`` files and write a CSV manifest of FLAC paths and
transcripts. The manifest is written with ``csv`` in the layout pandas'
``to_csv`` gives (a leading integer index column), which
``dataset.read_manifest`` reads.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import shutil
import sys
import urllib.request


def download_librispeech_subset(subset_name: str, download_dir: str) -> str:
    os.makedirs(download_dir, exist_ok=True)
    tar_path = os.path.join(download_dir, f'{subset_name}.tar.gz')
    if os.path.exists(tar_path):
        print(f'{tar_path} already exists - skipping download')
        return tar_path
    url = f'https://www.openslr.org/resources/12/{subset_name}.tar.gz'
    print(f'Downloading {url} -> {tar_path}')
    urllib.request.urlretrieve(url, tar_path)
    return tar_path


def extract_subset(subset_name: str, download_dir: str, extracted_dir: str):
    target = os.path.join(extracted_dir, 'LibriSpeech', subset_name)
    if os.path.exists(target):
        print(f'{target} already exists, skipping extraction')
        return
    os.makedirs(extracted_dir, exist_ok=True)
    print('Unpacking tarball')
    shutil.unpack_archive(os.path.join(download_dir, f'{subset_name}.tar.gz'),
                          extracted_dir)


def read_transcriptions(subset_name: str, extracted_dir: str):
    """[(flac_path, text)] from LibriSpeech's */*/*.trans.txt layout."""
    rows = []
    pattern = os.path.join(extracted_dir, 'LibriSpeech', subset_name,
                           '*/*/*.txt')
    for transcript_file in sorted(glob.glob(pattern)):
        base = os.path.dirname(transcript_file)
        with open(transcript_file) as f:
            for line in f:
                utt_id, _, text = line.partition(' ')
                rows.append((os.path.join(base, utt_id + '.flac'),
                             text.strip()))
    return rows


def write_csv_manifest(rows, manifest_path: str) -> None:
    """``rows`` of (audio_filepath, text) as pandas' ``to_csv`` writes a
    two-column frame: a header with an empty first field, an integer
    index, minimal quoting, ``\\n`` line ends."""
    with open(manifest_path, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow(['', 'audio_filepath', 'text'])
        for i, (path, text) in enumerate(rows):
            w.writerow([i, path, text])


def write_manifest(rows, manifest_path: str, absolute_paths: bool = False):
    if absolute_paths:
        rows = [(os.path.abspath(p), t) for p, t in rows]
    write_csv_manifest(rows, manifest_path)
    print(f'Done - manifest created at {manifest_path} ({len(rows)} '
          'utterances)')


def main(argv=None):
    parser = argparse.ArgumentParser('LibriSpeech data preparation.')
    parser.add_argument('--subset', default='dev-clean',
                        help='LibriSpeech subset to download')
    parser.add_argument('--download_dir', default='.',
                        help='where the tarball lands')
    parser.add_argument('--extracted_dir', default='./extracted',
                        help='where the archive is unpacked')
    parser.add_argument('--manifest_path', default='df.csv',
                        help='output CSV manifest (feed to train)')
    parser.add_argument('--absolute_paths', action='store_true',
                        help='write absolute audio paths into the manifest')
    args = parser.parse_args(argv)

    download_librispeech_subset(args.subset, args.download_dir)
    extract_subset(args.subset, args.download_dir, args.extracted_dir)
    rows = read_transcriptions(args.subset, args.extracted_dir)
    if not rows:
        print('No transcripts found - is the archive complete?',
              file=sys.stderr)
        return 1
    write_manifest(rows, args.manifest_path, args.absolute_paths)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
