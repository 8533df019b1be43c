"""
digiKam / XMP integration: write MD detection categories into image XMP
sidecar metadata (hierarchical subject tags) so photo managers can filter
by them.

Behavioral contract follows the reference
(megadetector/api/batch_processing/integration/digiKam/
xmp_integration.py:465): per-image tags like 'MegaDetector|animal' above
a confidence threshold, written to .xmp sidecar files (never modifying
the original images).

The port's own copy of megadetector_tpu/integration/xmp_integration.py:
the same public names, signatures, defaults and output bytes; its
progress bars are plain loops.
"""

import argparse
import json
import os
import sys
import threading

XMP_TEMPLATE = '''<?xpacket begin="﻿" id="W5M0MpCehiHzreSzNTczkc9d"?>
<x:xmpmeta xmlns:x="adobe:ns:meta/">
 <rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#">
  <rdf:Description rdf:about=""
    xmlns:dc="http://purl.org/dc/elements/1.1/"
    xmlns:lr="http://ns.adobe.com/lightroom/1.0/">
   <dc:subject>
    <rdf:Bag>
{subjects}
    </rdf:Bag>
   </dc:subject>
   <lr:hierarchicalSubject>
    <rdf:Bag>
{hierarchical}
    </rdf:Bag>
   </lr:hierarchicalSubject>
  </rdf:Description>
 </rdf:RDF>
</x:xmpmeta>
<?xpacket end="w"?>
'''


def _tags_for_image(im, detection_categories, classification_categories,
                    confidence_threshold, classification_threshold,
                    tag_prefix='MegaDetector'):
    tags = set()
    for det in im.get('detections') or []:
        if det['conf'] < confidence_threshold:
            continue
        name = detection_categories.get(det['category'], det['category'])
        tags.add('{}|{}'.format(tag_prefix, name))
        for c in det.get('classifications') or []:
            if c[1] >= classification_threshold:
                class_name = classification_categories.get(c[0], c[0])
                tags.add('{}|{}|{}'.format(tag_prefix, name, class_name))
    if not tags and im.get('detections') is not None:
        tags.add('{}|empty'.format(tag_prefix))
    return sorted(tags)


def write_xmp_sidecar(image_path, tags):
    """Write (overwrite) an .xmp sidecar next to [image_path]."""

    subjects = '\n'.join(
        '     <rdf:li>{}</rdf:li>'.format(t.split('|')[-1])
        for t in tags)
    hierarchical = '\n'.join(
        '     <rdf:li>{}</rdf:li>'.format(t) for t in tags)
    xmp_path = os.path.splitext(image_path)[0] + '.xmp'
    with open(xmp_path, 'w', encoding='utf-8') as f:
        f.write(XMP_TEMPLATE.format(subjects=subjects,
                                    hierarchical=hierarchical))
    return xmp_path


def write_results_to_xmp(results_file, image_folder,
                         confidence_threshold=0.2,
                         classification_threshold=0.5,
                         tag_prefix='MegaDetector'):
    """
    Write XMP sidecars for every image in an MD results file. Returns the
    list of sidecar paths written.
    """

    with open(results_file) as f:
        data = json.load(f)

    detection_categories = data.get('detection_categories', {})
    classification_categories = data.get('classification_categories', {})

    written = []
    for im in data['images']:
        if im.get('detections') is None:
            continue
        image_path = os.path.join(image_folder, im['file'])
        if not os.path.isfile(image_path):
            continue
        tags = _tags_for_image(
            im, detection_categories, classification_categories,
            confidence_threshold, classification_threshold, tag_prefix)
        written.append(write_xmp_sidecar(image_path, tags))

    print('Wrote {} XMP sidecars'.format(len(written)))
    return written


#%% Reference-exact digiKam surface
#
# The reference ships this integration as a small tool with an optional
# tkinter GUI that writes 'Xmp.lr.hierarchicalSubject' *into* the image
# files via pyexiv2 (reference: api/batch_processing/integration/digiKam/
# xmp_integration.py:35-460). The exact-name API below reproduces that
# behavior; when pyexiv2 is unavailable (it is not a dependency of this
# framework) tags fall back to the sidecar writer above, and the GUI is
# gated on tkinter.

#: digiKam tag names for the three MD categories (reference:
#: xmp_integration.py:30)
category_mapping = {'person': 'Human', 'animal': 'Animal',
                    'vehicle': 'Vehicle'}


class xmp_gui:
    """
    Handles to the tkinter widgets the processing thread reads/updates
    (reference: xmp_integration.py:35-43).
    """

    root = None
    textarea_min_threshold = None
    textarea_status = None
    textarea_remove_path = None
    textarea_rename_conf = None
    textarea_rename_cats = None
    textarea_num_threads = None
    progress_bar = None
    style = None
    num_threads = 1


class xmp_integration_options:
    """
    Options for process_input_data (reference:
    xmp_integration.py:45-70). String-typed thresholds are part of the
    reference contract (they arrive from GUI text areas).
    """

    #: Folder where images are stored
    image_folder = None
    #: .json file containing MegaDetector output
    input_file = None
    #: String to remove from all path names (a prefix added during MD
    #: processing)
    remove_path = None
    #: Optionally *rename* images with no detections above [rename_conf]
    #: for the categories in rename_cats from x.jpg to x_check.jpg
    rename_conf = None
    #: Comma-delimited list of category names (or 'all') the rename_conf
    #: behavior applies to
    rename_cats = None
    #: Minimum detection confidence (string; '' or None means 0.0)
    min_threshold = None
    num_threads = 1
    xmp_gui = None


def write_status(options, s):
    """Append [s] to the GUI status area (no-op without a GUI)."""

    if options.xmp_gui is None:
        return
    import tkinter
    options.xmp_gui.textarea_status.configure(state='normal')
    options.xmp_gui.textarea_status.insert(tkinter.END, s + '\n')
    options.xmp_gui.textarea_status.configure(state='disabled')


n_images_processed = 0
_progress_lock = threading.Lock()


def _write_hierarchical_subject(img_path, image_categories):
    """
    Write digiKam hierarchical-subject tags for one image: into the
    image's XMP block when pyexiv2 is available (the reference behavior,
    xmp_integration.py:148-149), else to an .xmp sidecar.
    """

    try:
        import pyexiv2
        img = pyexiv2.Image(r'{0}'.format(img_path))
        img.modify_xmp({'Xmp.lr.hierarchicalSubject': image_categories})
    except ImportError:
        write_xmp_sidecar(img_path, image_categories)


def update_xmp_metadata(categories, options, rename_cats, n_images,
                        image):
    """
    Update the XMP metadata for a single image record (reference:
    xmp_integration.py:86-195): collect the digiKam tag for every
    above-threshold detection category, write
    Xmp.lr.hierarchicalSubject, and optionally rename low-confidence
    images to *_check.* for manual review. Never raises — errors are
    printed and reported to the GUI.
    """

    filename = ''
    img_path = ''
    global n_images_processed

    try:
        filename = image['file']
        if options.remove_path is not None and len(options.remove_path) > 0:
            filename = filename.replace(options.remove_path, '')
        img_path = os.path.join(options.image_folder, filename)
        assert os.path.isfile(img_path), \
            'Image {} not found'.format(img_path)

        have_threshold = (options.min_threshold is not None
                          and len(str(options.min_threshold)) > 0)

        # digiKam tags to write; original MD category names with
        # above-threshold detections; max conf per original category
        image_categories = []
        original_image_cats = []
        original_image_cats_conf = {}

        for detection in (image.get('detections') or []):
            cat_name = categories[detection['category']]
            cat = category_mapping.get(cat_name, cat_name)
            if cat not in image_categories:
                if not have_threshold or \
                        float(detection['conf']) > \
                        float(options.min_threshold):
                    image_categories.append(cat)
                    original_image_cats.append(cat_name)
            # Track the max confidence per category unconditionally:
            # the rename check below needs it whether or not a
            # min_threshold was set
            if detection['conf'] > \
                    original_image_cats_conf.get(cat_name, 0):
                original_image_cats_conf[cat_name] = detection['conf']

        _write_hierarchical_subject(img_path, image_categories)

        # The rename/_check behavior (reference: xmp_integration.py:152-170)
        if not (options.rename_conf is None and
                options.rename_cats is None):
            matching_cats = \
                set(rename_cats).intersection(set(original_image_cats))
            is_conf_low = False
            if options.rename_conf is not None and \
                    len(str(options.rename_conf)) > 0:
                for matching_cat in matching_cats:
                    if original_image_cats_conf.get(matching_cat, 0) < \
                            float(options.rename_conf):
                        is_conf_low = True
            no_detections = have_threshold and \
                len(image.get('detections') or []) == 0
            if no_detections or (is_conf_low and len(matching_cats) > 0):
                parent_folder = os.path.dirname(img_path)
                file_name = os.path.basename(img_path)
                base, ext = os.path.splitext(file_name)
                os.rename(img_path, os.path.join(
                    parent_folder, base + '_check' + ext))

        if options.xmp_gui is not None:
            with _progress_lock:
                n_images_processed += 1
                percentage = round(n_images_processed / n_images * 100)

            # Worker threads must not touch tkinter widgets directly;
            # root.after() queues the update onto the GUI event loop
            def _update(pct=percentage):
                options.xmp_gui.progress_bar['value'] = pct
            options.xmp_gui.root.after(0, _update)

    except Exception as e:
        s = 'Error processing image {}: {}'.format(filename, str(e))
        print(s)
        write_status(options, s)


def process_input_data(options):
    """
    Loop over the images in options.input_file and write their XMP
    metadata with a worker pool (reference: xmp_integration.py:198-260).
    """

    from functools import partial
    from multiprocessing.pool import ThreadPool

    if options.xmp_gui is not None:
        options.remove_path = options.xmp_gui.textarea_remove_path.get()
        options.rename_conf = options.xmp_gui.textarea_rename_conf.get()
        options.rename_cats = options.xmp_gui.textarea_rename_cats.get()
        options.num_threads = options.xmp_gui.textarea_num_threads.get()
        options.min_threshold = \
            options.xmp_gui.textarea_min_threshold.get()

    with open(options.input_file, 'r') as f:
        data = json.load(f)
    categories = data['detection_categories']
    images = data['images']
    n_images = len(images)

    if not (options.rename_conf is None and options.rename_cats is None) \
            and options.rename_cats is not None:
        rename_cats = str(options.rename_cats).split(',')
        if rename_cats[0] == 'all':
            rename_cats = list(category_mapping.keys())
    else:
        rename_cats = []

    num_threads = int(options.num_threads) \
        if len(str(options.num_threads)) > 0 else 1

    global n_images_processed
    n_images_processed = 0

    func = partial(update_xmp_metadata, categories, options, rename_cats,
                   n_images)
    if num_threads <= 1 and options.xmp_gui is None:
        for im in images:
            func(im)
    else:
        # Threads, not processes: the work is IO-bound, and the GUI
        # progress callbacks must land in-process
        with ThreadPool(num_threads) as p:
            list(p.imap_unordered(func, images))

    s = 'Successfully processed {} images'.format(n_images)
    print(s)
    write_status(options, s)


def start_input_processing(options):
    """Run process_input_data on a worker thread (GUI path)."""

    import threading
    t = threading.Thread(target=lambda: process_input_data(options))
    t.start()
    return t


def browse_folder(options, folder_path_var):
    """GUI callback: pick the image folder."""

    import tkinter.filedialog
    filename = tkinter.filedialog.askdirectory()
    options.image_folder = r'{0}'.format(filename)
    folder_path_var.set(filename)


def browse_file(options, file_path_var):
    """GUI callback: pick the MD results .json."""

    import tkinter.filedialog
    filename = tkinter.filedialog.askopenfilename()
    options.input_file = r'{0}'.format(filename)
    file_path_var.set(filename)


def create_gui(options):
    """
    Minimal tkinter front-end over process_input_data (reference:
    xmp_integration.py:283-423): folder/file pickers, threshold and
    rename fields, a status area, and a progress bar.
    """

    import tkinter
    from tkinter import ttk

    gui = xmp_gui()
    root = tkinter.Tk()
    root.resizable(False, False)
    root.title('digiKam integration')
    gui.root = root

    frame = tkinter.Frame(root)
    frame.pack(padx=10, pady=10)

    folder_path_var = tkinter.StringVar()
    file_path_var = tkinter.StringVar()

    tkinter.Label(frame, text='Folder containing images').grid(
        row=0, column=0, sticky='w')
    tkinter.Entry(frame, textvariable=folder_path_var, width=50).grid(
        row=0, column=1)
    tkinter.Button(
        frame, text='Browse',
        command=lambda: browse_folder(options, folder_path_var)).grid(
            row=0, column=2)

    tkinter.Label(frame, text='MegaDetector output file').grid(
        row=1, column=0, sticky='w')
    tkinter.Entry(frame, textvariable=file_path_var, width=50).grid(
        row=1, column=1)
    tkinter.Button(
        frame, text='Browse',
        command=lambda: browse_file(options, file_path_var)).grid(
            row=1, column=2)

    labels_and_attrs = [
        ('Path to remove from image paths', 'textarea_remove_path'),
        ('Confidence threshold', 'textarea_min_threshold'),
        ('Rename-for-review confidence', 'textarea_rename_conf'),
        ('Rename categories (or "all")', 'textarea_rename_cats'),
        ('Number of threads', 'textarea_num_threads'),
    ]
    for i, (label, attr) in enumerate(labels_and_attrs):
        tkinter.Label(frame, text=label).grid(row=2 + i, column=0,
                                              sticky='w')
        entry = tkinter.Entry(frame, width=50)
        entry.grid(row=2 + i, column=1)
        setattr(gui, attr, entry)

    gui.progress_bar = ttk.Progressbar(
        frame, orient='horizontal', length=400, mode='determinate')
    gui.progress_bar.grid(row=7, column=0, columnspan=3, pady=5)

    status = tkinter.Text(frame, height=8, width=70, state='disabled')
    status.grid(row=8, column=0, columnspan=3)
    gui.textarea_status = status

    tkinter.Button(
        frame, text='Process',
        command=lambda: start_input_processing(options)).grid(
            row=9, column=1, pady=5)

    options.xmp_gui = gui
    root.mainloop()


def main():
    parser = argparse.ArgumentParser(
        description='Write MD detections into XMP sidecar tags')
    parser.add_argument('results_file')
    parser.add_argument('image_folder')
    parser.add_argument('--confidence_threshold', type=float, default=0.2)
    parser.add_argument('--embedded', action='store_true',
                        help='write tags into the image XMP blocks '
                             '(reference behavior; requires pyexiv2) '
                             'instead of sidecars')
    parser.add_argument('--remove_path', default=None)
    parser.add_argument('--rename_conf', default=None)
    parser.add_argument('--rename_cats', default=None)
    parser.add_argument('--num_threads', type=int, default=1)
    parser.add_argument('--gui', action='store_true',
                        help='launch the tkinter front-end')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    if args.gui or args.embedded or args.rename_conf is not None or \
            args.rename_cats is not None or args.remove_path is not None:
        options = xmp_integration_options()
        options.image_folder = args.image_folder
        options.input_file = args.results_file
        options.remove_path = args.remove_path
        options.rename_conf = args.rename_conf
        options.rename_cats = args.rename_cats
        options.min_threshold = str(args.confidence_threshold)
        options.num_threads = args.num_threads
        if args.gui:
            create_gui(options)
        else:
            process_input_data(options)
    else:
        write_results_to_xmp(args.results_file, args.image_folder,
                             confidence_threshold=args.confidence_threshold)


if __name__ == '__main__':
    main()
