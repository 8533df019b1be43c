"""
Shared inputs for the port's Wildlife Insights and SpeciesNet tests (numpy,
pandas and the standard library only): a WI taxonomy with geofencing
rules and country codes, a seeded SpeciesNet predictions file, a seeded WI
download bundle, and a loopback HTTP server that records what is posted to
it.
"""

import http.server
import json
import os
import threading
import uuid

import numpy as np

TAXONOMY_LINES = [
    '5c7ce479-8a45-40b3-ae21-7c97dfae22f5;mammalia;cetartiodactyla;'
    'cervidae;odocoileus;virginianus;white-tailed deer',
    'aaaaaaaa-0000-0000-0000-000000000001;mammalia;carnivora;felidae;'
    'puma;concolor;puma',
    'aaaaaaaa-0000-0000-0000-000000000002;mammalia;rodentia;;;;rodent',
    'aaaaaaaa-0000-0000-0000-000000000003;mammalia;carnivora;canidae;'
    'canis;lupus dingo;dingo',
    'aaaaaaaa-0000-0000-0000-000000000004;mammalia;carnivora;canidae;'
    'vulpes;vulpes;red fox',
    'aaaaaaaa-0000-0000-0000-000000000005;mammalia;carnivora;canidae;;;'
    'canine family',
    'aaaaaaaa-0000-0000-0000-000000000006;aves;;;;;bird',
    # No uuid: a 6-token row the handler reads as ';' + row
    'mammalia;primates;hominidae;homo;sapiens;human',
]

DEER = 'mammalia;cetartiodactyla;cervidae;odocoileus;virginianus'
PUMA = 'mammalia;carnivora;felidae;puma;concolor'
DINGO = 'mammalia;carnivora;canidae;canis;lupus dingo'
FOX = 'mammalia;carnivora;canidae;vulpes;vulpes'

GEOFENCE = {
    DEER: {'allow': {'USA': ['AL', 'AR', 'AZ'], 'CAN': []}},
    PUMA: {'block': {'AUS': []}},
    DINGO: {'allow': {'AUS': []}, 'block': {'USA': []}},
    FOX: {'allow': {'USA': [], 'CAN': []}, 'block': {'USA': ['HI']}},
}

COUNTRY_CSV = (
    'name,alpha-2,alpha-3\n'
    'United States of America,US,USA\n'
    'Canada,CA,CAN\n'
    'Australia,AU,AUS\n'
    'Argentina,AR,ARG\n'
)

BLANK = 'f1856211-cfb7-4a5b-9158-c0f72fd09ee6;;;;;;blank'
HUMAN = ('990ae9dd-7a59-4344-afcb-1b7b21368000;mammalia;primates;'
         'hominidae;homo;sapiens;human')
VEHICLE = 'e2895ed5-780b-48f6-8a11-9e27cb594511;;;;;;vehicle'
NO_CV = 'f2efdae9-efb8-48fb-8a91-eccf79ab4ffb;no cv result;;;;;no cv result'


def geofence_files(folder):
    """(geofencing .json, country-code .csv) written into [folder]."""

    geofence_file = os.path.join(str(folder), 'geofence.json')
    with open(geofence_file, 'w') as f:
        json.dump(GEOFENCE, f)
    cc_file = os.path.join(str(folder), 'codes.csv')
    with open(cc_file, 'w') as f:
        f.write(COUNTRY_CSV)
    return geofence_file, cc_file


def seeded_uuid(rng):
    return str(uuid.UUID(int=int(rng.randint(0, 2 ** 62)) << 64 |
                         int(rng.randint(0, 2 ** 62)), version=4))


def ensemble_predictions(n=24, seed=0, base='/data/images'):
    """A SpeciesNet ensemble predictions dict over [n] images in two
    cameras: each image's detections (some none), its classifier's top-5
    classes and scores (descending), and an ensemble 'prediction' that is
    sometimes the top class, sometimes a geofenced or rolled-up other,
    blank, human or vehicle; one image failed."""

    rng = np.random.RandomState(seed)
    strings = TAXONOMY_LINES[:7] + [HUMAN, BLANK, VEHICLE]
    predictions = []
    for i in range(n):
        path = '{}/cam{}/img_{:03d}.jpg'.format(base, i % 2, i)
        if i == 5:
            predictions.append({'filepath': path, 'failures': ['DETECTOR']})
            continue
        detections = []
        for _ in range(int(rng.randint(0, 4)) if i % 7 else 0):
            category = str(int(rng.choice([1, 1, 1, 2, 3])))
            x, y = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.05, 0.35, 2)
            detections.append({
                'category': category,
                'label': {'1': 'animal', '2': 'human',
                          '3': 'vehicle'}[category],
                'conf': round(float(rng.uniform(0.05, 0.99)), 4),
                'bbox': [round(float(v), 4) for v in (x, y, w, h)]})
        detections.sort(key=lambda d: -d['conf'])
        order = rng.permutation(len(strings))[:5]
        scores = sorted((round(float(v), 5) for v in rng.uniform(0, 1, 5)),
                        reverse=True)
        classes = [strings[j] for j in order]
        choice = rng.uniform()
        if choice < 0.5:
            prediction, score = classes[0], scores[0]
        elif choice < 0.8:
            prediction, score = classes[int(rng.randint(1, 5))], scores[1]
        else:
            prediction, score = str(rng.choice([BLANK, HUMAN])), 0.9
        predictions.append({
            'filepath': path, 'detections': detections,
            'classifications': {'classes': classes, 'scores': scores},
            'prediction': prediction, 'prediction_score': score,
            'prediction_source': 'classifier', 'model_version': '4.0.1a'})
    return {'predictions': predictions}


def bundle_rows(project_id, n=8, seed=0, deployments=('dep001', 'dep002')):
    """WI download-bundle image rows over [n] seeded image GUIDs: human-
    and computer-identified, blank, unidentified and multi-species rows
    (an image twice, once per species)."""

    rng = np.random.RandomState(seed)
    species = [('Mammalia', 'Rodentia', '', '', '', 'Rodent', 0,
                'Computer vision'),
               ('Mammalia', 'Carnivora', 'Felidae', 'Puma', 'concolor',
                'Puma', 0, 'Jane Expert'),
               ('', '', '', '', '', 'Blank', 1, 'Jane Expert'),
               ('', '', '', '', '', '', 0, ''),
               ('Mammalia', 'Cetartiodactyla', 'Cervidae', 'Odocoileus',
                'virginianus', 'White-tailed Deer', 0, 'A Person')]
    rows = []
    for i in range(n):
        guid = seeded_uuid(rng)
        deployment = deployments[i % len(deployments)]
        kinds = [species[i % len(species)]]
        if i == 1:
            kinds.append(species[4])
        for cls, order, family, genus, sp, common, is_blank, ident in kinds:
            rows.append({
                'project_id': project_id,
                'deployment_id': deployment,
                'image_id': guid,
                'filename': guid + '.JPG',
                'location': 'gs://bucket_{}/deployment/{}/prod/'
                            'directUpload/{}.JPG'.format(
                                project_id, 2241000 + i % 2, guid),
                'identified_by': ident,
                'wi_taxon_id': seeded_uuid(rng),
                'class': cls, 'order': order, 'family': family,
                'genus': genus, 'species': sp, 'common_name': common,
                'uncertainty': '', 'is_blank': is_blank,
                'number_of_objects': 1 + i % 3, 'age': '', 'sex': '',
                'animal_recognizable': '', 'individual_id': '',
                'individual_animal_notes': '', 'behavior': '',
                'highlighted': '', 'markings': '', 'cv_confidence': '',
                'license': 'CC-BY-4.0',
                'timestamp': '2024-01-{:02d} 10:00:{:02d}'.format(
                    1 + i // 4, (i % 4) * 20)})
    return rows


def write_bundle(folder, rows, project_id):
    """images_<project_id>.csv of [rows] in [folder]; returns its path."""

    import pandas as pd

    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, 'images_{}.csv'.format(project_id))
    pd.DataFrame(rows).to_csv(path, index=False)
    return path


class RecordingServer:
    """A ThreadingHTTPServer on 127.0.0.1 (a free port) that records every
    POST (path, headers, JSON body) and answers {'token': ...} on paths
    ending in /token and {'ok': true} elsewhere. Use as a context
    manager; [url] is its base."""

    def __init__(self, token='tok-loopback'):
        self.requests = []
        self.lock = threading.Lock()
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers['Content-Length']))
                with server.lock:
                    server.requests.append((self.path, dict(self.headers),
                                            json.loads(body)))
                answer = {'token': token} if self.path.endswith('/token') \
                    else {'ok': True}
                data = json.dumps(answer).encode()
                self.send_response(200)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(('127.0.0.1', 0),
                                                     Handler)
        self.url = 'http://127.0.0.1:{}'.format(self.httpd.server_port)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()
